"""The port's CUDA kernels against their plain PyTorch versions on the card,
over shapes beyond the main path's: ragged M, C = 1, narrow tiles, relu^2,
K1 at its launch plan's row-block boundaries and at olmo-1b's N 8192, K1's
plan against the runtime's resident clusters and its refusal of pointers
TMA cannot take, K2 at its plan's boundaries, on an all-empty gate and on
unions wider than one chunk, as one launch, with its plan's clusters
resident, past K 4096 and past K 8192 (llama3-405b's K 16384 at its N
53248), the non-gated down projection past one column slice, at
every row-block width of its plan, on empty rows and row blocks and on
unions wider than one chunk, as one launch, with its plan's clusters
resident, head dims 16..128, GQA groups up to 16, block sizes up to
64, boundary and padded rows, tile-skip thresholds and dead tiles at every
row-block width of K5's plan (and its resident clusters), causal
attention over ragged sequence lengths and padded head dims, paged chunk
attention split over a cluster (live keys in every split, empty splits,
512 rows, over 2048 keys) and causal attention in more than one wave of
blocks, bit-identical from run to run, paged decode attention as one
launch with its plan's clusters resident, and the hybrid products over both
sides of the format, bf16 and float32 (K8 and K9 at the train phase's
batch with 216 columns alive, on a pattern scattered over all N, on a row
block with no ELL row, each as one launch; K8 with f32 values on a bf16 W
and, on an f32 W, in the per-row kernel's f32 FMA order; past N 16384 on
the wide union maps, at deepseek-67b's and llama3-405b's d_ff), and one
training step of a 4-layer paper-0.5b under ``remat="full"`` against
``"none"``: the same gradients bit for bit, a lower peak; the mesh train
step and ``moe_apply_sorted`` on a one-rank NCCL mesh against their CPU
plain paths. Marked ``cuda``: each
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
] + [  # K1's launch plan: M at the block-width and row-block boundaries
    (m, 2048, 5632, 256, 8, "relu", 0.02)
    for m in (8, 9, 20, 64, 65, 128, 129, 256)
] + [  # olmo-1b's W_u and zamba2-1.2b's shared W_g (K2 at its K 2048, N
    # 8192), decode and prefill
    (m, 2048, 8192, 256, 8, "relu", 0.02) for m in (4, 256)
] + [  # llama-3.2-vision-11b's gated FFN (K1 + K2 at K 4096, N 14336), decode
    # and a 64-row chunk
    (m, 4096, 14336, 256, 8, "relu", 0.02) for m in (4, 64)
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
    v2, i2, z2 = twell_gate_matmul_cuda(x, wg, t, c, act)  # same bits
    assert torch.equal(v, v2) and torch.equal(i, i2) and torch.equal(z, z2)
    tc = t // c
    tw = twell.TwellActs(pv, pi, torch.clamp(pz, max=tc), (pz > tc).any(),
                         t, c, n)
    y = twell_fused_ffn_cuda(x, tw, wu.t().contiguous(), wd)
    py = twell_fused_ffn_plain(x, tw, wu.t().contiguous(), wd)
    torch.testing.assert_close(y, py.float(), **TOL)


@pytest.mark.parametrize("shape", [  # (M, K, N): serving, then wider K1
    (4, 2048, 5632), (20, 2048, 5632), (64, 2048, 5632), (256, 2048, 5632),
    (4, 2048, 8192), (256, 2048, 8192), (300, 512, 1024)], ids=str)
def test_gate_plan_clusters_resident(card, shape):
    """K1's plan counts on its clusters being resident at once: the
    CUDA runtime's count (cudaOccupancyMaxActiveClusters) holds them
    all."""
    from repro_torch.kernels import twell_pack as tp
    m, k, n = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = tp.gate_plan(m, k, n, 256, sms)
    assert plan.blocks // plan.ks <= tp.gate_resident_clusters(256, plan)


def test_gate_matmul_refuses_misaligned_pointers(card):
    """TMA needs 16-byte aligned x and W: a contiguous view one element
    past an aligned start raises before any launch."""
    from repro_torch.kernels.twell_pack import twell_gate_matmul_cuda
    x, wg, _, _ = _gate(4, 64, 256, 0.5, 0, card)
    xo = torch.empty(4 * 64 + 1, dtype=torch.bfloat16,
                     device=card)[1:].view(4, 64)
    wo = torch.empty(64 * 256 + 1, dtype=torch.bfloat16,
                     device=card)[1:].view(64, 256)
    assert xo.is_contiguous() and wo.is_contiguous()
    with pytest.raises(ValueError):
        twell_gate_matmul_cuda(xo, wg, 64, 4)
    with pytest.raises(ValueError):
        twell_gate_matmul_cuda(x, wo, 64, 4)


def _fused_case(m, k, n, t, c, keep, seed, dev, x_zero=False):
    """x, K1-plain-packed gate (clipped to T/C as ops clips it), W_u^T, W_d
    on the card; x all zero when ``x_zero`` (an all-empty gate)."""
    from repro_torch.core import twell
    from repro_torch.kernels.twell_pack import twell_gate_matmul_plain
    x, wg, wu, wd = _gate(m, k, n, keep, seed, dev)
    if x_zero:
        x = torch.zeros_like(x)
    v, i, z = twell_gate_matmul_plain(x, wg, t, c, "relu")
    tc = t // c
    tw = twell.TwellActs(v, i, torch.clamp(z, max=tc), (z > tc).any(), t, c,
                         n)
    return x, tw, wu.t().contiguous(), wd


@pytest.mark.parametrize("m", [1, 4, 8, 9, 20, 64, 65, 128, 129, 256, 300])
def test_fused_ffn_plan_boundaries_match_plain(card, m):
    """K2 at every width and row-block boundary of its plan (8-64 rows a
    block), paper-0.5b's FFN, within bf16 tolerance, the same bits on a
    second call."""
    from repro_torch.kernels.sparse_ffn import (twell_fused_ffn_cuda,
                                                twell_fused_ffn_plain)
    args = _fused_case(m, 2048, 5632, 256, 8, 0.02, m, card)
    y = twell_fused_ffn_cuda(*args)
    torch.testing.assert_close(y, twell_fused_ffn_plain(*args).float(),
                               **TOL)
    assert torch.equal(y, twell_fused_ffn_cuda(*args))


@pytest.mark.parametrize("case", ["all_empty", "keep1_m256", "keep1_ragged"])
def test_fused_ffn_empty_and_scattered_unions(card, case):
    """An all-empty gate (an empty union: y all zero) and gates with every
    column alive (at C 8 overflowed tiles clipped to T/C; rows of more
    than 128 valid slots, so a row block's union is wider than one
    128-position chunk, up to all of N), against the plain version, the
    same bits on a second call."""
    from repro_torch.kernels.sparse_ffn import (twell_fused_ffn_cuda,
                                                twell_fused_ffn_plain)
    shape = {"all_empty": (20, 2048, 5632, 256, 8, 0.02),
             "keep1_m256": (256, 2048, 5632, 256, 8, 1.0),
             "keep1_ragged": (37, 200, 768, 64, 1, 1.0)}[case]
    args = _fused_case(*shape, 3, card, x_zero=case == "all_empty")
    y = twell_fused_ffn_cuda(*args)
    if case == "all_empty":
        assert int(args[1].nnz.sum()) == 0 and not bool(y.abs().max())
    else:
        assert int(args[1].nnz.sum(-1).max()) > 128
        assert bool(args[1].overflow) == (case == "keep1_m256")
    torch.testing.assert_close(y, twell_fused_ffn_plain(*args).float(),
                               **TOL)
    assert torch.equal(y, twell_fused_ffn_cuda(*args))


@pytest.mark.parametrize("shape", [  # (M, K, N, T, C, keep) past K 4096:
    (4, 5120, 8192, 256, 8, 0.02), (64, 5120, 8192, 256, 8, 0.02),  # llama4
    (4, 6144, 16384, 256, 8, 0.02), (64, 6144, 16384, 256, 8, 0.02),  # mixtral
    (300, 6144, 16384, 256, 8, 0.02), (20, 8192, 22016, 256, 8, 0.02),
    (37, 4608, 768, 64, 1, 1.0), (5, 5128, 512, 64, 4, 0.3)], ids=str)
def test_fused_ffn_wide_k_matches_plain(card, shape):
    """K2 past K 4096 (a rank of 9-16 K stages, 6 or 8 slices of y, the
    ring landing each phase in groups), the MoE experts' shapes, the
    widest K, a union over many chunks and a K that is not a multiple of
    64, within bf16 tolerance, the same bits on a second call, and the
    plan's clusters resident as at the narrow shapes."""
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels import twell_pack as tp
    m, k, n, t, c, keep = shape
    args = _fused_case(m, k, n, t, c, keep, 7, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = sf.fused_ffn_plan(m, k, n, t, c, sms)
    assert plan.slices in sf.FUSED_FFN_WIDE_SLICES and not plan.whole
    y = sf.twell_fused_ffn_cuda(*args)
    torch.testing.assert_close(y, sf.twell_fused_ffn_plain(*args).float(),
                               **TOL)
    assert torch.equal(y, sf.twell_fused_ffn_cuda(*args))
    held, smem = sf.fused_ffn_resident_clusters(k, n, t, plan)
    assert smem == plan.smem
    if tp.one_wave(plan.row_blocks, plan.ks, 1, sms):
        assert plan.row_blocks <= held


def _fused_case_on_card(m, k, n, keep, seed, dev, scale=0.08):
    """``_fused_case`` (T 256, C 8) with the operands drawn on the card from
    a seeded generator (llama3-405b's W_u and W_d are 872 M entries each),
    the weights at std ``scale``."""
    from repro_torch.core import twell
    from repro_torch.kernels.twell_pack import twell_gate_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).bfloat16()
    x = r(m, k, scale=0.5)
    col = torch.rand((n,), generator=gen, device=dev) < keep
    wg = (r(k, n, scale=scale) * col[None]).bfloat16()
    wu_t, wd = r(n, k, scale=scale), r(n, k, scale=scale)
    v, i, z = twell_gate_matmul_plain(x, wg, 256, 8, "relu")
    del wg
    tw = twell.TwellActs(v, i, torch.clamp(z, max=32), (z > 32).any(), 256,
                         8, n)
    return x, tw, wu_t, wd


@pytest.mark.parametrize("shape", [  # (M, K, N) past K 8192: llama3-405b
    (4, 16384, 53248), (64, 16384, 53248), (256, 16384, 53248),
    (4, 12288, 53248), (64, 12288, 53248), (256, 12288, 53248)], ids=str)
def test_fused_ffn_widest_k_matches_plain(card, shape):
    """K2 past K 8192 (a rank of up to 32 K stages, 16 slices of y in
    8-row blocks, the ring landing each phase in groups) at llama3-405b's
    FFN with 2% of the gate columns alive, the same bits on a second call.
    With the weights' std 0.08 scaled by sqrt(2048 / K) (h_u and h of the
    magnitudes of the K-2048 cases): within bf16 tolerance of the plain
    version. At std 0.08 itself h is ~2.8x larger (~25), and its one bf16
    rounding (ulp 0.125 there) flips where the kernel's and cuBLAS's f32
    sums of h_u differ in the last bits: y moves by up to ~0.13 (measured
    on the H100), past 2e-2 on the elements of y near zero. There the
    kernel and the plain version are each held within the bound of that
    rounding (``_h_rounding_bound``) of y with h unrounded."""
    from repro_torch.kernels import sparse_ffn as sf
    m, k, n = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = sf.fused_ffn_plan(m, k, n, 256, 8, sms)
    assert plan.slices in sf.FUSED_FFN_WIDEST_SLICES and plan.width == 8
    args = _fused_case_on_card(m, k, n, 0.02, 13, card,
                               scale=0.08 * (2048 / k) ** 0.5)
    y = sf.twell_fused_ffn_cuda(*args)
    torch.testing.assert_close(y, sf.twell_fused_ffn_plain(*args).float(),
                               **TOL)
    assert torch.equal(y, sf.twell_fused_ffn_cuda(*args))
    del args, y
    args = _fused_case_on_card(m, k, n, 0.02, 13, card)
    exact, bound = _h_rounding_bound(*args)
    for got in (sf.twell_fused_ffn_cuda(*args),
                sf.twell_fused_ffn_plain(*args).float()):
        assert bool(((got - exact).abs() <= bound).all()), \
            float(((got - exact).abs() - bound).max())


def _h_rounding_bound(x, tw, wu_t, wd):
    """(y with h = h_u * g unrounded, in f32; per element of y the most
    that rounding every h entry once to bf16 moves it, sum_j ulp(h_j) / 2
    |W_d[j, k]|, plus 1e-5 sum_j |h_j W_d[j, k]| for the f32 sums' own
    order)."""
    from repro_torch.core import twell
    h = (x.float() @ wu_t.float().t()) * twell.unpack(tw).float()
    half_ulp = torch.where(h != 0, torch.exp2(torch.floor(torch.log2(
        h.abs().clamp(min=1e-30))) - 8), torch.zeros((), device=h.device))
    wdf = wd.float()
    return h @ wdf, half_ulp @ wdf.abs() + 1e-5 * (h.abs() @ wdf.abs())


def test_fused_ffn_is_one_launch(card):
    """One K2 call is one kernel on the card (the union, both products and
    the rank-order sums in one launch): captured into a CUDA graph it is
    one kernel node and nothing else. It allocates only y."""
    from repro_torch.kernels.sparse_ffn import twell_fused_ffn_cuda
    args = _fused_case(256, 2048, 5632, 256, 8, 0.02, 5, card)
    twell_fused_ffn_cuda(*args)                        # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    y = twell_fused_ffn_cuda(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= -(-y.numel() * 4 // 512) * 512
    assert y.dtype == torch.float32 and y.shape == (256, 2048)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        twell_fused_ffn_cuda(*args)
    assert _graph_node_types(g) == [0]


@pytest.mark.parametrize("shape", [  # (M, K, N, T, C): decode, verify,
    (4, 2048, 5632, 256, 8), (20, 2048, 5632, 256, 8),  # prefill, wider
    (256, 2048, 5632, 256, 8), (300, 512, 1024, 256, 8),
    (4, 2048, 8192, 256, 8), (256, 4096, 5632, 256, 8)], ids=str)
def test_fused_ffn_plan_clusters_resident(card, shape):
    """K2's plan counts on its row blocks' clusters being resident at once
    (one block an SM): the CUDA runtime's count
    (cudaOccupancyMaxActiveClusters) holds them all where the plan keeps
    the grid to one wave, and a block's shared memory is the plan's."""
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels import twell_pack as tp
    m, k, n, t, c = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = sf.fused_ffn_plan(m, k, n, t, c, sms)
    held, smem = sf.fused_ffn_resident_clusters(k, n, t, plan)
    assert smem == plan.smem
    if tp.one_wave(plan.row_blocks, plan.ks, 1, sms):
        assert plan.row_blocks <= held


def test_fused_ffn_refuses_misaligned_pointers(card):
    """cp.async gathers 16-byte pieces of x, W_u^T and W_d: a contiguous
    view one element past an aligned start raises before any launch."""
    from repro_torch.kernels.sparse_ffn import twell_fused_ffn_cuda
    x, tw, wu_t, wd = _fused_case(4, 64, 256, 64, 2, 0.5, 0, card)
    xo = torch.empty(4 * 64 + 1, dtype=torch.bfloat16,
                     device=card)[1:].view(4, 64)
    xo.copy_(x)
    with pytest.raises(ValueError):
        twell_fused_ffn_cuda(xo, tw, wu_t, wd)


TILE_SKIP_SHAPES = [  # (M, K, N, T, act, keep, threshold, dead tiles)
    (4, 2048, 5632, 256, "relu", 0.02, 0.0, 11),  # main path, decode
    (4, 2048, 5632, 256, "relu", 0.3, 0.5, 11),
    (256, 2048, 5632, 256, "relu", 0.02, 0.0, 11),
    (1, 64, 256, 64, "relu", 0.3, 0.0, 0),
    (37, 128, 512, 128, "relu2", 0.1, 0.0, 1),
    (70, 256, 768, 256, "relu", 0.5, 0.3, 1),
    (33, 96, 512, 64, "relu2", 0.4, 0.05, 5),
] + [  # K5's plan: every width (8-128) and the second row block
    (8, 2048, 5632, 256, "relu", 0.02, 0.0, 11),
    (9, 2048, 5632, 256, "relu", 0.3, 0.5, 11),
    (20, 2048, 5632, 256, "relu2", 0.1, 0.05, 5),
    (128, 2048, 5632, 256, "relu", 0.02, 0.0, 11),
    (129, 1024, 2048, 128, "relu", 0.3, 0.5, 3),
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
    y2, h2 = tile_skip_ffn_cuda(x, wg, wu, wd, t, act, thr)  # same bits
    assert torch.equal(y, y2) and torch.equal(h, h2)
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


@pytest.mark.parametrize("shape", [  # (M, K, N, T): drafts, then wider
    (4, 2048, 5632, 256), (20, 2048, 5632, 256), (64, 2048, 5632, 256),
    (256, 2048, 5632, 256), (129, 1024, 2048, 128), (33, 96, 512, 64)],
    ids=str)
def test_tile_skip_plan_clusters_resident(card, shape):
    """K5's plan counts on the clusters of both kernels being resident at
    once: the CUDA runtime's count (cudaOccupancyMaxActiveClusters) holds
    them all, and each block's shared memory is the plan's."""
    from repro_torch.kernels import sparse_ffn as sf
    m, k, n, t = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = sf.tile_skip_plan(m, k, n, t, sms)
    up, up_smem, down, down_smem = sf.tile_skip_resident_clusters(t, plan, n)
    assert plan.blocks // plan.ks <= up
    assert plan.blocks_down // plan.ks_down <= down
    assert up_smem == sf.up_smem(t, plan.width, plan.stages, plan.g_rows)
    assert down_smem == sf.down_smem(plan.cols, plan.width, plan.stages_down,
                                     n // t)


DOWN_SHAPES = [  # (M, K, N, T, C, keep)
    (4, 2048, 8192, 256, 8, 0.02),               # olmo-1b decode
    (256, 2048, 8192, 256, 8, 0.02),             # olmo-1b 4 x 64-token chunk
    (2, 64, 256, 64, 1, 0.3),                    # K under one 256-column slice
    (37, 520, 512, 128, 4, 0.1),                 # K past one slice, ragged
    (9, 256, 1024, 256, 1, 1.0),                 # C = 1: every column a slot
    (16, 96, 512, 64, 8, 1.0),                   # overflowing pack, clipped
] + [  # K6's plan: rows a block 8 | 16, 32 (clusters split the union) | 64,
    # one | two row blocks
    (m, 2048, 8192, 256, 8, 0.02) for m in (8, 9, 32, 33, 64, 65)
] + [
    (70, 512, 1024, 128, 4, 0.0),                # every row block empty
    (256, 2048, 8192, 256, 8, 1.0),              # unions near N, clipped
    (40, 200, 768, 64, 1, 1.0),                  # union wider than a chunk
    (1024, 2048, 8192, 256, 8, 0.02),            # 2 slices of y a block
    (4096, 2048, 8192, 256, 8, 0.02),            # 4 slices, more than a wave
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


@pytest.mark.parametrize("m", [4, 64])
def test_relu2_gate_and_down_proj_at_rwkv6_shape(card, m):
    """rwkv6-7b's channel mix as the gather path serves it (K 4096, N
    14336, T 256, C 8, 2% of W_u's columns alive): K1 packs relu(x @
    W_u)^2, then K6 projects the plain version's packed pattern down; each
    within bf16 tolerance of its plain version, the same bits each run."""
    from repro_torch.kernels.sparse_ffn import (twell_down_proj_cuda,
                                                twell_down_proj_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    k, n, t, c = 4096, 14336, 256, 8
    x, wu, _, wd = _gate(m, k, n, 0.02, m + k, card)
    v, i, z = twell_gate_matmul_cuda(x, wu, t, c, "relu2")
    pv, pi, pz = twell_gate_matmul_plain(x, wu, t, c, "relu2")
    pre = x.float() @ wu.float()
    rows = ~((pre != 0) & (pre.abs() < 1e-3 * pre.abs().max())).any(-1)
    assert torch.equal(z[rows], pz[rows]) and torch.equal(i[rows], pi[rows])
    torch.testing.assert_close(v[rows].float(), pv[rows].float(), **TOL)
    assert torch.equal(v, twell_gate_matmul_cuda(x, wu, t, c, "relu2")[0])
    pz = torch.clamp(pz, max=t // c)
    y = twell_down_proj_cuda(pv, pi, pz, wd, t)
    torch.testing.assert_close(y, twell_down_proj_plain(pv, pi, pz, wd, t),
                               **TOL)
    assert torch.equal(y, twell_down_proj_cuda(pv, pi, pz, wd, t))


@pytest.mark.parametrize("m", [4, 6000])
def test_gate_and_down_proj_at_whisper_shape(card, m):
    """whisper-large-v3's non-gated FFN as the gather path serves it (K
    1280, N 5120, T 256, C 8, 2% of W_u's columns alive), at decode and
    over a 4-request encoder's 4 x 1500 frame rows: K1 packs relu(x @
    W_u), then K6 projects the plain version's packed pattern down; each
    within bf16 tolerance of its plain version, the same bits each run."""
    from repro_torch.kernels.sparse_ffn import (twell_down_proj_cuda,
                                                twell_down_proj_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    k, n, t, c = 1280, 5120, 256, 8
    x, wu, _, wd = _gate(m, k, n, 0.02, m + k, card)
    v, i, z = twell_gate_matmul_cuda(x, wu, t, c, "relu")
    pv, pi, pz = twell_gate_matmul_plain(x, wu, t, c, "relu")
    pre = x.float() @ wu.float()
    rows = ~((pre != 0) & (pre.abs() < 1e-3 * pre.abs().max())).any(-1)
    assert torch.equal(z[rows], pz[rows]) and torch.equal(i[rows], pi[rows])
    torch.testing.assert_close(v[rows].float(), pv[rows].float(), **TOL)
    assert torch.equal(v, twell_gate_matmul_cuda(x, wu, t, c, "relu")[0])
    pz = torch.clamp(pz, max=t // c)
    y = twell_down_proj_cuda(pv, pi, pz, wd, t)
    torch.testing.assert_close(y, twell_down_proj_plain(pv, pi, pz, wd, t),
                               **TOL)
    assert torch.equal(y, twell_down_proj_cuda(pv, pi, pz, wd, t))


def _down_case(m, k, n, t, c, keep, seed, dev, dead_rows=0):
    """K1-plain-packed relu(x @ W_u) (counts clipped to T/C as ops clips
    them) and W_d on the card; the last ``dead_rows`` rows of x zero."""
    from repro_torch.kernels.twell_pack import twell_gate_matmul_plain
    x, wu, _, wd = _gate(m, k, n, keep, seed, dev)
    if dead_rows:
        x[m - dead_rows:] = 0
    v, i, z = twell_gate_matmul_plain(x, wu, t, c, "relu")
    return v, i, torch.clamp(z, max=t // c), wd, t


def test_down_proj_empty_row_block_beside_a_live_one(card):
    """K6 with its second row block's rows all empty (an empty union:
    those rows of y zero) and its first live, in one launch, against the
    plain version, the same bits on a second call."""
    from repro_torch.kernels import sparse_ffn as sf
    args = _down_case(70, 2048, 8192, 256, 8, 0.02, 7, card, dead_rows=6)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert sf.down_proj_plan(70, 2048, 8192, 256, 8, sms).row_blocks == 2
    assert int(args[2][64:].sum()) == 0 and int(args[2][:64].sum()) > 0
    y = sf.twell_down_proj_cuda(*args)
    assert not bool(y[64:].abs().max())
    torch.testing.assert_close(y, sf.twell_down_proj_plain(*args), **TOL)
    assert torch.equal(y, sf.twell_down_proj_cuda(*args))


def test_down_proj_is_one_launch(card):
    """One K6 call is one kernel on the card (the union, the scatter and the
    products in one launch): it adds one to its launch count, and captured
    into a CUDA graph it is one kernel node and nothing else. It allocates
    only y."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_ffn import twell_down_proj_cuda
    args = _down_case(256, 2048, 8192, 256, 8, 0.02, 5, card)
    twell_down_proj_cuda(*args)                        # build and warm
    torch.cuda.synchronize()
    launches = build.LAUNCHES["twell_down_proj"]
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    y = twell_down_proj_cuda(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["twell_down_proj"] == launches + 1
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= -(-y.numel() * 4 // 512) * 512
    assert y.dtype == torch.float32 and y.shape == (256, 2048)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        twell_down_proj_cuda(*args)
    assert _graph_node_types(g) == [0]


@pytest.mark.parametrize("shape", [  # (M, K, N, T, C): olmo-1b decode,
    (4, 2048, 8192, 256, 8), (20, 2048, 8192, 256, 8),  # 32 rows a block,
    (64, 2048, 8192, 256, 8), (256, 2048, 8192, 256, 8),  # prefill, wider
    (300, 2048, 8192, 256, 8), (37, 520, 512, 128, 4),
    (1024, 2048, 8192, 256, 8)], ids=str)
def test_down_proj_plan_clusters_resident(card, shape):
    """K6's plan counts on its clusters being resident at once (one block
    an SM): the CUDA runtime's count (cudaOccupancyMaxActiveClusters) holds
    them all where the plan keeps the grid to one wave, and a block's
    shared memory is the plan's."""
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels import twell_pack as tp
    m, k, n, t, c = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = sf.down_proj_plan(m, k, n, t, c, sms)
    held, smem = sf.down_proj_resident_clusters(k, n, t, plan)
    assert smem == plan.smem
    if tp.one_wave(plan.blocks // plan.ks, plan.ks, 1, sms):
        assert plan.blocks // plan.ks <= held


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
    (3, 3, 1, 96, 16, 10),        # hd 96 (two panels, the second half zero)
    (3, 2, 4, 96, 8, 9),          # hd 96, GQA
    (2, 8, 8, 128, 16, 9),        # deepseek-67b's GQA: 8 KV heads, G 8
    (2, 8, 16, 128, 16, 9),       # llama3-405b's: 8 KV heads, G 16
    (4, 2, 2, 64, 16, 128),       # 2048 keys: K3 at CL 8, 4 tiles a rank
    (2, 2, 2, 64, 16, 1),         # a one-page table
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


DECODE_PLAN_SHAPES = [  # (B, H, Hkv, hd, width, bs)
    (4, 32, 32, 64, 34, 16), (4, 32, 8, 64, 64, 16), (4, 16, 16, 128, 34, 16),
    (1, 32, 32, 64, 34, 16), (2, 16, 16, 128, 64, 16),
    (3, 48, 3, 96, 300, 8), (4, 32, 2, 64, 128, 16)]


@pytest.mark.parametrize("shape", DECODE_PLAN_SHAPES, ids=str)
def test_decode_plan_clusters_resident(card, shape):
    """K3's plan counts on its B x Hkv clusters being resident at once:
    the CUDA runtime's count (cudaOccupancyMaxActiveClusters) holds them
    all, and a block's shared memory is the plan's."""
    from repro_torch.kernels.attention_plan import decode_plan
    from repro_torch.kernels.paged_decode_attention import \
        decode_resident_clusters
    b, h, hkv, hd, width, bs = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = decode_plan(b, h, hkv, hd, width, bs, sms)
    held, smem = decode_resident_clusters(hd, h // hkv, width, plan.cluster)
    assert plan.cluster > 1 and plan.clusters <= held
    assert smem == plan.smem


def _decode_case(dev, b=4, hkv=8, g=4, hd=128, bs=16, width=64):
    rng = np.random.RandomState(7)
    kp, vp, bt = _paged(rng, b, hkv, hd, bs, width, dev)
    sl = torch.tensor([1000, 517, 33, 700][:b], dtype=torch.int32,
                      device=dev)
    q = _bf16(rng.randn(b, 1, hkv * g, hd), dev)
    return q, kp, vp, bt, sl


def test_paged_decode_is_one_launch(card):
    """One K3 call is one kernel on the card (no merge kernels after it)
    and allocates only its bf16 output (no f32 partials)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    args = _decode_case(card)
    paged_decode_attention_cuda(*args)                 # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert o.dtype == torch.bfloat16 and o.shape == args[0].shape
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= -(-o.numel() * 2 // 512) * 512


def test_paged_decode_same_bits_every_run(card):
    """The splits merge in rank order: two calls give the same bits."""
    from repro_torch.kernels.attention_plan import decode_plan
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    q, kp, vp, bt, sl = _decode_case(card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert decode_plan(4, 32, 8, 128, 64, 16, sms).cluster > 1
    assert torch.equal(paged_decode_attention_cuda(q, kp, vp, bt, sl),
                       paged_decode_attention_cuda(q, kp, vp, bt, sl))


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
    (2, 1024, 4, 128),        # olmo-1b's training shape: hd 128, S 1024
    (8, 1024, 32, 96),        # phi3-mini's training shape: hd 96 padded
    (8, 1024, 20, 64),        # whisper-large-v3's decoder: 20 heads of 64
    (1, 200, 2, 96),          # hd 96, S ragged
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


# K7 at shapes with S not a multiple of the 128-row query tile and more
# work items (batch x head x query tiles) than the H100's 132 SMs, so the
# persistent blocks take several items each in heaviest-first order (and
# refill both Q slots and the K/V ring across items)
FLASH_WAVE_SHAPES = [  # (B, S, H, hd)
    (4, 1000, 8, 64),         # 32 x 8 = 256 items
    (2, 777, 12, 128),        # 24 x 7 = 168 items, key tile 64
    (3, 1100, 7, 40),         # 21 x 9 = 189 items, hd padded to 64
]


@pytest.mark.parametrize("shape", FLASH_WAVE_SHAPES, ids=str)
def test_flash_attention_heavy_first_waves(card, shape):
    from repro_torch.kernels.attention_plan import flash_plan
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    b, s, h, hd = shape
    plan = flash_plan(b, s, h, hd, 132)
    assert s % 128 and plan.n_bh * plan.n_q_tiles > 132
    q, k, v = _qkv(shape, torch.bfloat16, card, sum(shape))
    o = flash_attention_cuda(q, k, v)
    po = flash_attention_plain(q, k, v)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), po.float(), **TOL)
    assert torch.equal(o, flash_attention_cuda(q, k, v))


# K4 with the keys of a row tile split over a thread-block cluster
CHUNK_SPLIT_CASES = [  # (Hkv, G, hd, bs, width, S, seq_lens, num_new)
    # 2464 live keys over all 8 splits (> 2048); a short request leaves
    # most splits without a live key; a padded request
    (2, 2, 64, 16, 160, 64, [2400, 100, 0], [64, 30, 0]),
    # G * S = 512 rows: four 128-row tiles, each over 4 splits
    (2, 8, 64, 16, 64, 64, [900, 0, 0], [64, 64, 0]),
    # olmo-1b's head dim, 4 splits
    (4, 1, 128, 16, 64, 64, [900, 100, 0], [64, 40, 0]),
    # phi3-mini's head dim 96 (padded to 128), 4 splits
    (4, 1, 96, 16, 64, 64, [900, 100, 0], [64, 40, 0]),
    # 8-key pages, hd 32 padded to 64, cluster capped at 8 (2400 keys)
    (4, 1, 32, 8, 300, 16, [2380, 7, 0], [16, 3, 0]),
]


@pytest.mark.parametrize("case", CHUNK_SPLIT_CASES, ids=str)
def test_paged_chunk_cluster_splits(card, case):
    """Every split of request 0 holds live keys, request 1 leaves splits
    empty, request 2 is padding (exactly zero); live rows within bf16
    tolerance of the plain version; the same bits from run to run."""
    from repro_torch.kernels.attention_plan import chunk_plan, chunk_splits
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention_cuda, paged_chunk_attention_plain)
    hkv, g, hd, bs, width, s, sl, nn = case
    b = len(sl)
    plan = chunk_plan(b, s, hkv * g, hkv, width, bs)
    kend = [min(sl_ + nn_, width * bs) if nn_ else sl_
            for sl_, nn_ in zip(sl, nn)]
    assert plan.cluster > 1
    assert all(hi > lo for lo, hi in chunk_splits(kend[0], plan.cluster))
    assert any(hi == lo for lo, hi in chunk_splits(kend[1], plan.cluster))
    rng = np.random.RandomState(sum(sl) + hd)
    kp, vp, bt = _paged(rng, b, hkv, hd, bs, width, card)
    bt[2] = 0
    sl_t = torch.tensor(sl, dtype=torch.int32, device=card)
    nn_t = torch.tensor(nn, dtype=torch.int32, device=card)
    q = _bf16(rng.randn(b, s, hkv * g, hd), card)
    o = paged_chunk_attention_cuda(q, kp, vp, bt, sl_t, nn_t)
    po = paged_chunk_attention_plain(q, kp, vp, bt, sl_t, nn_t)
    assert torch.isfinite(o.float()).all()
    valid = torch.arange(s, device=card)[None, :] < nn_t[:, None]
    torch.testing.assert_close(o.float()[valid], po.float()[valid], **TOL)
    assert float(o[2].float().abs().max()) == 0.0
    assert torch.equal(o, paged_chunk_attention_cuda(q, kp, vp, bt, sl_t,
                                                     nn_t))


def _hybrid_case(m, n, k, e, dense_rows, dtype, dev, seed, kind="random"):
    """A hybrid pattern with rows on both sides of the format: ~e/2
    non-zeros a row, and ``dense_rows`` rows with more than e. ``kind``
    "alive216": each row takes 108 of the same 216 columns (the train
    phase's gate, K9's union two chunks of 128); "scattered": 108 columns a
    row drawn over all N (K9's union near N); "backup_block": the dense
    rows are the first ones (a row block with no ELL row)."""
    from repro_torch.core import hybrid as hyb
    rng = np.random.RandomState(seed)
    if kind in ("alive216", "scattered"):
        pool = rng.permutation(n)[:216] if kind == "alive216" else \
            np.arange(n)
        pick = np.argpartition(rng.rand(m, pool.size), 108, axis=1)[:, :108]
        h = np.zeros((m, n))
        h[np.arange(m)[:, None], pool[pick]] = rng.randn(m, 108)
    else:
        h = np.where(rng.rand(m, n) < 0.5 * e / n, rng.randn(m, n), 0.0)
    dense = np.arange(dense_rows) if kind == "backup_block" else \
        rng.permutation(m)[:dense_rows]
    h[dense] = rng.randn(dense_rows, n)
    hy = hyb.pack(torch.from_numpy(h.astype(np.float32)).to(dev).to(dtype),
                  e, max(1, dense_rows))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32)).to(dev)
    return hy, x.to(dtype), w.to(dtype)


HYBRID_SHAPES = [  # (M, N, K, E, dense rows[, kind])
    (1, 64, 8, 4, 0),
    (37, 256, 64, 16, 3),
    (300, 512, 136, 32, 10),
    (40, 384, 72, 10, 2),         # E % 4: K9 reads indices 4 bytes a copy
    (5, 128, 2056, 8, 1),         # K past one 1024-column slice
    (8, 2048, 64, 1024, 1),       # the widest ELL row the kernels take
    (512, 5632, 2048, 128, 8),    # paper-0.5b's FFN
    # the train phase's batch at paper-0.5b's FFN, 216 columns alive
    (8192, 5632, 2048, 128, 8, "alive216"),
    (8192, 5632, 2048, 128, 8, "scattered"),   # K9's worst case
    (300, 512, 136, 32, 128, "backup_block"),  # a row block all backup
    # whisper-large-v3's encoder FFN in a training step: 8 x 1500 frame
    # rows, K 1280, N 5120
    (12000, 5120, 1280, 128, 8, "alive216"),
    # past N 16384, the wide union maps: deepseek-67b's and llama3-405b's
    # d_ff, 216 columns alive, and a random pattern over all of N
    (2048, 22016, 1024, 128, 8, "alive216"),
    (2048, 53248, 1024, 128, 8, "alive216"),
    (300, 53248, 136, 32, 10),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", HYBRID_SHAPES, ids=str)
def test_hybrid_matmuls_match_plain(card, shape, dtype):
    """K8 (ELL side of h @ W, with float32 slot values too, as the backward
    passes them: exactly bf16 ones and, a third of them, ones bf16 cannot
    hold, which a bf16 W takes as hi + lo) and K9 (the SDDMM on the
    pattern, both orientations of the products' W) against their plain
    versions: float32 outputs, equal to 1e-4 relative (f32 sums in other
    orders), the same bits from run to run, 0 on backup rows and invalid
    slots."""
    from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                                   dense_to_hybrid_plain,
                                                   hybrid_to_dense_cuda,
                                                   hybrid_to_dense_plain)
    m, n, k, e, dense, *kind = shape
    hy, x, w = _hybrid_case(m, n, k, e, dense, dtype, card,
                            sum(shape[:5]), *kind)
    live = ~hy.is_dense
    assert int(hy.is_dense.sum()) == dense and not bool(hy.overflow)
    tol = dict(rtol=1e-4, atol=1e-4)
    for vals in (hy.ell_values, hy.ell_values.float(),
                 hy.ell_values.float() / 3):
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


def _graph_node_types(g):
    """The node types of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    (0: a kernel), through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int
    graph, n = g.raw_cuda_graph(), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(node, ctypes.byref(t)) == 0
        types.append(t.value)
    return types


def test_dense_to_hybrid_is_one_launch(card):
    """One bf16 K9 call is one kernel on the card (the union, the products
    and the pick in one launch): captured into a CUDA graph it is one
    kernel node and nothing else. It allocates only its f32 values. (A
    torch.profiler session after another in the same process recorded no
    kernel, so the graph counts.)"""
    from repro_torch.kernels.hybrid_matmul import dense_to_hybrid_cuda
    hy, x, w = _hybrid_case(512, 5632, 2048, 128, 8, torch.bfloat16, card,
                            11, "alive216")
    args = (x, w, hy.ell_indices, hy.row_nnz, ~hy.is_dense)
    dense_to_hybrid_cuda(*args)                        # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    vals = dense_to_hybrid_cuda(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= -(-vals.numel() * 4 // 512) * 512
    assert vals.dtype == torch.float32 and vals.shape == (512, 128)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        dense_to_hybrid_cuda(*args)
    assert _graph_node_types(g) == [0]


@pytest.mark.parametrize("vdtype", [torch.bfloat16, torch.float32],
                         ids=str)
def test_hybrid_to_dense_is_one_launch(card, vdtype):
    """One K8 call on a bf16 W, with bf16 values and with f32 ones, is one
    kernel on the card (the union, the h tile and the products in one
    launch, no copy of the values): captured into a CUDA graph it is one
    kernel node and nothing else. It allocates only y."""
    from repro_torch.kernels.hybrid_matmul import hybrid_to_dense_cuda
    hy, x, w = _hybrid_case(512, 5632, 2048, 128, 8, torch.bfloat16, card,
                            12, "alive216")
    vals = hy.ell_values.to(vdtype)
    args = (vals, hy.ell_indices, hy.row_nnz, ~hy.is_dense, w)
    hybrid_to_dense_cuda(*args)                        # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    y = hybrid_to_dense_cuda(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= -(-y.numel() * 4 // 512) * 512
    assert y.dtype == torch.float32 and y.shape == (512, 2048)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        hybrid_to_dense_cuda(*args)
    assert _graph_node_types(g) == [0]


def test_hybrid_to_dense_f32_keeps_its_fma_order(card):
    """An f32 W takes the per-row kernel unchanged: each y element is
    fmaf(v, w, acc) over the row's valid slots in slot order, from 0. The
    reference replays that order on the CPU, each FMA exact in float64 (a
    product of two floats has 48 bits) and rounded once to float32."""
    from repro_torch.kernels.hybrid_matmul import hybrid_to_dense_cuda
    hy, _, w = _hybrid_case(64, 256, 128, 16, 2, torch.float32, card, 13)
    live = ~hy.is_dense
    y = hybrid_to_dense_cuda(hy.ell_values, hy.ell_indices, hy.row_nnz,
                             live, w).cpu()
    vals = hy.ell_values.cpu().double()
    idx = hy.ell_indices.cpu().long()
    nnz = torch.where(live, hy.row_nnz, 0).cpu()
    wd = w.cpu().double()
    want = torch.zeros((64, 128), dtype=torch.float32)
    for e in range(16):
        on = (e < nnz)[:, None]
        step = (vals[:, e:e + 1] * wd[idx[:, e]] + want.double()).float()
        want = torch.where(on, step, want)
    assert torch.equal(y, want)


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


# --------------------------------------------------------------------------- #
# the serving engine's step programs: one CUDA graph per entry and bucket key
# --------------------------------------------------------------------------- #

def _graph_engine(dev):
    """A speculating, graph-replaying engine on a small bf16 paper-0.5b
    (2 layers, d_model 512, 8 heads of 64, d_ff 1024, T 256, C 8), 98% of
    the gate columns zeroed as in chip_smoke, the pools filled with noise so
    every read sees data."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, SpecConfig
    cfg = get_config("paper-0.5b").reduced(
        d_model=512, d_ff=1024, num_heads=8, num_kv_heads=8, head_dim=64,
        vocab_size=1024, dtype="bfloat16", param_dtype="bfloat16")
    params = lm.init(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    alive = torch.rand((cfg.num_layers, 1, cfg.d_ff), generator=gen,
                       device=dev) < 0.02
    params["blocks"]["ffn"]["wg"] *= alive.to(params["blocks"]["ffn"]["wg"])
    engine = ServingEngine(params, cfg, backend="gather", block_size=16,
                           max_batch=4, max_seq_len=128,
                           spec=SpecConfig(k=3, draft_backend="tile_skip",
                                           draft_threshold=0.5), device=dev)
    for p in engine.kv.pools.values():
        p.normal_(generator=gen)
    return engine


@pytest.mark.parametrize("entry", ["decode", "prefill", "draft", "verify"])
def test_program_replay_equals_eager_bitwise(card, entry):
    """One replay of each entry's program against the model function called
    directly, on the same inputs from the same copy of the pools: outputs
    and the written K/V (the null block left out) bitwise equal."""
    from repro_torch.models import lm
    e = _graph_engine(card)
    p, w = e.params, e.table_width
    rng = np.random.RandomState(3)
    bt = (1 + np.arange(4)[:, None] * w + np.arange(w)[None]).astype(np.int32)

    def ints(*shape):
        return rng.randint(0, e.cfg.vocab_size, shape).astype(np.int32)
    sl0 = np.array([100, 37, 70, 5], np.int32)
    dlen = np.array([3, 3, 1, 0], np.int32)
    if entry == "decode":
        prog, args = e._jit_decode(4, 8, True), [bt[:, :8],
                                                 np.array([120, 60, 7, 0],
                                                          np.int32),
                                                 ints(4, 1)]

        def eager(b, s, t):
            last = lm.paged_decode_step(p, e.kv.pools, b, s, t,
                                        e.cfg_decode)[0][:, -1]
            return last.argmax(-1), last
    elif entry == "prefill":
        prog, args = e._jit_prefill(4, 32, True), [
            bt, ints(4, 32), np.array([0, 16, 90, 3], np.int32),
            np.array([32, 9, 32, 1], np.int32)]

        def eager(b, t, s, n):
            last = lm.paged_prefill(p, e.kv.pools, b, t, n, e.cfg_prefill,
                                    start_lens=s, last_only=True)[0][:, 0]
            return last.argmax(-1), last
    elif entry == "draft":
        prog, args = e._jit_draft(4, True), [bt, sl0, ints(4, 1), dlen]

        def eager(b, s, t, d):
            return e.drafter.draft(p, e.kv.pools, b, s, t, d, None, None,
                                   None, None, greedy=True)[:2]
    else:
        drafts = torch.from_numpy(ints(4, 3).astype(np.int64)).to(card)
        prog, args = e._jit_verify(4), [
            bt, sl0, (dlen + (dlen > 0)).astype(np.int32), ints(4, 1),
            drafts]

        def eager(b, s, n, t, d):
            return (e.verifier.verify(p, e.kv.pools, b, s, n, torch.cat(
                [t, d.to(t.dtype)], dim=1))[0],)
    pools = e.kv.pools
    snap = {n: t.clone() for n, t in pools.items()}
    got = prog(*args)
    got = [t.clone() for t in (got if isinstance(got, tuple) else (got,))]
    written = {n: t.clone() for n, t in pools.items()}
    for n, t in pools.items():
        t.copy_(snap[n])
    want = eager(*[torch.from_numpy(a).to(card) if isinstance(a, np.ndarray)
                   else a for a in args])
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    # block 0 left out: the null block takes every padded position's
    # write, and which of several writes to one slot lands is not defined
    for n in pools:
        assert torch.equal(written[n][:, 1:], pools[n][:, 1:])
    assert any(not torch.equal(written[n][:, 1:], snap[n][:, 1:])
               for n in pools)
    assert e.programs.made[entry] == 1


def _gate_program(card, m=16, k=96, n=512, t=64, c=8, keep=1.0):
    """A program around K1 alone, at a gate that overflows T/C when
    ``keep`` is 1 (as GATE_SHAPES' overflowing case); its input is x in
    float32 on the host."""
    from repro_torch.kernels import ops
    from repro_torch.serving.graphs import Program
    x, wg, _, _ = _gate(m, k, n, keep, 0, card)
    prog = Program(lambda xf: ops.twell_gate_matmul(
        xf.to(torch.bfloat16), wg, t, c).values,
        [x.float().cpu().numpy()], card)
    return prog, x.float().cpu().numpy()


def test_overflow_seen_through_replay_after_reset(card):
    """The captured graph ORs into the flag the log reads, also after a
    ``reset()`` (which zeroes the flag in place), and a replay on a gate
    that does not overflow leaves it clear."""
    from repro_torch.kernels import ops
    prog, x = _gate_program(card)
    for _ in range(2):
        ops.OverflowLog.reset()
        assert not ops.OverflowLog.seen()
        prog(x)
        torch.cuda.synchronize()
        assert ops.OverflowLog.seen()
    ops.OverflowLog.reset()
    prog(np.zeros_like(x))
    torch.cuda.synchronize()
    assert not ops.OverflowLog.seen()


def test_replay_adds_captured_launch_counts(card):
    """A program's capture counts no launch; each replay adds what the
    capture recorded."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    prog, x = _gate_program(card, keep=0.1)
    # the eager run before capture launched K1 once; the capture, nothing
    assert ops.launch_counts()["twell_gate_matmul"] == 1
    assert prog.launches == {"twell_gate_matmul": 1}
    for i in range(1, 4):
        prog(x)
        assert ops.launch_counts()["twell_gate_matmul"] == 1 + i
    eager = ops.twell_gate_matmul(torch.from_numpy(x).to(card).bfloat16(),
                                  _gate(16, 96, 512, 0.1, 0, card)[1], 64, 8)
    assert torch.equal(prog(x), eager.values)


def test_failed_capture_raises_and_keeps_no_program(card):
    """No fallback: an entry that cannot be captured (a host sync) raises,
    every time it is asked for, and no program is kept or counted."""
    from repro_torch.serving.graphs import ProgramCache
    cache = ProgramCache(card)
    w = torch.ones(8, device=card)

    def fn(x):
        return x * float((x @ w).sum())          # a host sync: not capturable

    for _ in range(2):
        with pytest.raises(RuntimeError):
            cache.get("decode", (1,), fn,
                      lambda: [np.ones((4, 8), np.float32)])
    assert cache.made["decode"] == 0 and not cache._programs


def test_remat_full_equals_none_with_a_lower_peak(card):
    """One loss and gradient of paper-0.5b at full width, 4 layers, hybrid
    FFN with 216 gate columns alive, 4 x 1024 tokens, under remat "none"
    and "full" from the same weights and batch: the loss and every
    gradient equal bit for bit (recomputation reruns the same kernels,
    which use no atomics), and full's peak memory below none's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path, tree_map
    base = get_config("paper-0.5b")
    base = dataclasses.replace(base, num_layers=4, sparsity=dataclasses
                               .replace(base.sparsity, ffn_impl="hybrid"))
    params = lm.trainable(lm.init(base, device=card, seed=0))
    gen = torch.Generator(device=card).manual_seed(1)
    for wg in params["blocks"]["ffn"]["wg"]:
        alive = torch.zeros(base.d_ff, device=card)
        alive[torch.randperm(base.d_ff, generator=gen, device=card)[:216]] = 1
        wg *= alive.to(wg)
    tokens = torch.randint(0, base.vocab_size, (4, 1025), generator=gen,
                           device=card, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    out = {}
    for mode in ("none", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        named = list(leaves_with_path(live))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = lm.loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        torch.cuda.synchronize()
        out[mode] = (loss.detach(), grads, torch.cuda.max_memory_allocated())
        del live, named, loss
    (l0, g0, p0), (l1, g1, p1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert p1 < p0, (p1, p0)


def test_serve_tp_beyond_the_cards_refuses(card):
    """--tp past the visible cards exits non-zero and names the count: no
    rank falls back to gloo, to the CPU or to fewer ranks."""
    from repro_torch.launch import serve
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--backend", "dense", "--tp", str(n + 1)])
    assert f"needs {n + 1} cards" in str(e.value.code) and \
        f"{n} visible" in str(e.value.code)


def _mesh_on_card(rank, dev, cfg, moe_cfg, params, batch, moe_params, x):
    """The train step and the sorted MoE on a one-rank NCCL mesh."""
    from repro_torch import training
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    mesh = mesh_mod.make_train_mesh((1, 1, 1), ("pod", "data", "model"),
                                    dev)
    on = lambda t: t.to(dev)  # noqa: E731
    p = tree_map(on, params)
    step = training.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=4), mesh=mesh)
    ops.reset_launch_counts()
    p1, _, m = step(p, adamw.init(p), tree_map(on, batch))
    launches = ops.launch_counts()
    y, aux = moe.moe_apply_sorted(tree_map(on, moe_params), on(x), moe_cfg,
                                  moe_cfg.sparsity, True, mesh,
                                  ("pod", "data"))
    return ({k: float(v) for k, v in m.items()}, tree_map(
        lambda t: t.cpu(), p1), launches, y.cpu(), float(aux["moe_drop_frac"]))


def test_mesh_train_step_and_sorted_moe_on_one_nccl_rank(card):
    """The mesh train step (reduced paper-0.5b, float32, hybrid FFN with
    48 of 128 gate columns alive: K7, K8 and K9) on a (1, 1, 1) NCCL
    mesh against the CPU's unsharded step, and ``moe_apply_sorted`` at
    capacity 8 (nothing drops) against the CPU's one-hot dispatch."""
    import dataclasses
    from repro_torch import training
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks
    from repro_torch.models import lm, moe
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    cfg = get_config("paper-0.5b").reduced()
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl="hybrid"))
    params = lm.trainable(lm.init(cfg, device="cpu", seed=0))
    params["blocks"]["ffn"]["wg"][..., 48:] = 0
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    moe_cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                                  capacity_factor=8.0)
    mp = moe.moe_init(moe_cfg.d_model, moe_cfg.d_ff, moe_cfg.num_experts,
                      True, torch.float32, gen, torch.device("cpu"))
    x = torch.randn((2, 32, moe_cfg.d_model), generator=gen)
    m, p1, launches, y, drop = ranks.in_one_rank(
        _mesh_on_card, card, (cfg, moe_cfg, params, batch, mp, x))
    assert all(launches[k] > 0 for k in ("flash_attention",
                                         "hybrid_to_dense",
                                         "dense_to_hybrid")), launches
    step = training.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=4))
    q1, _, want = step(params, adamw.init(params), batch)
    for k in ("loss", "ce", "grad_norm", "nnz_mean"):
        np.testing.assert_allclose(m[k], float(want[k]), **TOL)
    for a, b in zip(leaves(p1), leaves(q1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    y_ref, _ = moe.moe_apply_onehot(mp, x, moe_cfg, moe_cfg.sparsity, True)
    assert drop == 0.0
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
