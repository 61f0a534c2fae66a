// K2: fused up + down projection from the packed TwELL gate (paper Eq. 3).
//
// Replaces src/repro/kernels/sparse_ffn.py:50 twell_fused_ffn_pallas (its
// _kernel): y = ((x @ W_u) * unpack(g)) @ W_d, h = h_u * g rounded to bf16
// once with both factors in f32, y in f32; h_u and h never reach device
// memory.
//
// What bounds it on the H100: at the serving shapes (K 2048, N 5632, T 256,
// C 8, ~2% of the gate columns alive) a row block's union of live columns
// is ~113, so the bytes a call must move are x, the valid prefixes of the
// packed gate, each distinct W_u^T row and W_d row once (~0.9 MB) and y in
// f32: 0.3 us at M 4 and 1.3 us at M 256 at 3.35 TB/s. The products over
// the union padded to 128 are ~0.13 GFLOP at M 256: negligible. So the
// kernel is all fixed cost and latency: it must not recompute, must read
// each W row once a row block, and must spread those reads over many SMs.
// (The first version took a block per (row, 256-column K slice), so each
// of a row's ~50 dot products ran once per K slice, and ran the down
// projection on CUDA cores one slot at a time.)
//
// Design (primitives from sm90_common.cuh; the union from twell_union.cuh,
// shared with K6):
//   * grid (ks, row blocks), a cluster of ks blocks a row block of NW rows
//     (M rounded up to 8, 16, 32 or 64), two warpgroups a block. The K
//     dimension is split over the cluster in whole 64-deep stages (K1's
//     split): rank r owns stages kb .. kb + ns - 1, both as the reduction
//     range of the up product and as its columns of y. NW, ks and the ring
//     depth come from the host plan (kernels/sparse_ffn.py: fused_ffn_plan,
//     from shapes and the SM count; every cluster resident at once). Up to
//     K 4096 a rank holds at most 8 stages (4 slices of y); past it up to
//     16 (6 or 8 slices, narrower row blocks), up to K 8192; past that up
//     to 32 (16 slices, 8-row blocks: 64 accumulators a thread), up to K
//     16384 (llama3-405b's d_model);
//   * the union, built on the card (the host never reads the pattern):
//     each (row, tile)'s count read in the same round as its first 8 slot
//     indices (one 32-byte sector; slot s of tile t is valid iff s <
//     nnz[m, t], nnz clipped to T/C; later slots only up to the count),
//     the valid columns marked in a byte map of N, folded into a bitmap a
//     thread a run of words, and a prefix popcount scanned over the block:
//     the union's U columns in ascending order, and any column's position
//     (the prefix of its word plus the bits below it). Every rank marks
//     all the block's rows; from 32 rows a block (`split`) each rank marks
//     only its own share and the ranks OR their bitmaps through
//     distributed shared memory (DSMEM) after a cluster barrier;
//   * the union in chunks of UC = 128 positions. For each chunk:
//     up: D (128 positions x NW rows) = W_u^T[U_c, k range] x[rows, k
//     range]^T on wgmma m64nNWk16, swap-AB with both operands K-major
//     (WgmmaKA): A = the chunk's W_u^T rows gathered by index, B = x's
//     rows, kept in shared memory for the whole call. One warpgroup per
//     64-position slab. The f32 partials go to shared memory;
//     h: after a cluster barrier rank r sums its share of the rows over
//     the ranks' partials in rank order (16-byte pieces through DSMEM; no
//     atomics), then for each valid slot of those rows whose column falls
//     in the chunk multiplies the sum by the gate value in f32 and rounds
//     once to bf16 into its h tile (NW rows x 128 positions, K-major,
//     128B-swizzled, zero elsewhere). A row's valid slots hold distinct
//     columns (each column lies in one tile, and K1 writes each non-zero
//     once), so each h entry gets at most one write. The first 8 slots of
//     a thread's first (row, tile) are kept in registers from the union
//     pass. After a second barrier every rank copies the other ranks' rows
//     of h into its own tile (whole 128-byte rows through DSMEM), so all
//     wgmma operands are written by this block's own threads;
//     down: y[rows, its columns] += h[rows, U_c] W_d[U_c, its columns],
//     swap-AB (WgmmaTA): A = the chunk's W_d rows gathered by index, read
//     MN-major (each row 64 y columns), B = the h tile, K-major; 128 y
//     columns a step, one warpgroup per 64. The accumulators persist over
//     the chunks (a scattered union loops);
//   * every W row goes through one cp.async ring of 16 KB stages (128 rows
//     x 64 bf16, 16-byte pieces, 128B-swizzled, zero past U and past K;
//     TMA has no gather), used a phase at a time (a chunk's ns up stages,
//     then its down stages: one barrier and one wgmma wait a phase) and
//     refilled as far ahead as it holds, so the W_d rows land while the up
//     product and the scatter run. Where the ring holds less than a phase
//     (past K 4096 the rank's 9-32 stages and x's tile leave room for 3-8)
//     a phase lands in groups of half the ring, the other half in flight;
//   * y is stored straight from the accumulators: each element has one
//     writer and a fixed summation order, so a repeated call gives the same
//     bits. A row block whose union is empty writes its zeros.
// Every branch around a wgmma depends only on values uniform over the
// block (U, ns, the stage counter); zeroed accumulators are fenced
// (fence_regs).
#include <cooperative_groups.h>

#include "sm90_common.cuh"
#include "twell_union.cuh"

namespace cg = cooperative_groups;
using namespace sm90;
using twell_union::MAX_KS;
using twell_union::staging_bytes;

namespace {

constexpr int THREADS = 256;              // two consumer warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int BK = 64;                    // k, or y columns, of a stage
constexpr int UC = 128;                   // union positions a chunk
constexpr uint32_t PANEL = 64 * PANEL_ROW;  // 64 rows x 128 bytes
constexpr uint32_t UNIT = 2 * PANEL;      // a ring stage: 128 rows
constexpr int PS = UC + 4;                // a partial row, in floats
constexpr int MAX_STAGES = 8;             // ring depth
constexpr size_t SMEM_MAX = 232448;       // a block's shared memory

// Byte offsets in the 1024-aligned dynamic shared memory of a block of NW
// rows, s_max stages a rank at most, a ring of nst stages and N columns
// (kernels/sparse_ffn.py: fused_ffn_smem computes the same end + 1 KB).
// The byte map of N is staged over the ring before it starts.
struct Layout {
  uint32_t x, h, part, bits, lbits, pre, cols, u, end;
  __host__ __device__ Layout(int nw, int s_max, int nst, int n) {
    const uint32_t nwd = (n + 31) / 32;
    x = nst * UNIT;                        // [s_max] panels of NW rows
    h = x + s_max * nw * PANEL_ROW;        // [2] panels of NW rows
    part = h + 2 * nw * PANEL_ROW;         // f32 [NW][PS]
    bits = part + nw * PS * 4;             // u32 [nwd]
    lbits = bits + 4 * nwd;                // u32 [nwd], this rank's
    pre = lbits + 4 * nwd;                 // int [nwd]
    cols = pre + 4 * nwd;                  // u16 [N]
    u = cols + ((2 * n + 15) & ~15u);      // U, then the warps' totals
    end = u + 4 * (WARPS + 4);
  }
};

__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// prefetch to L2 the 128-byte lines of bytes [p, p + n)
__device__ __forceinline__ void prefetch_lines(const void* p, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (uintptr_t q = (a & ~(uintptr_t)127) + 128 * threadIdx.x; q < a + n;
       q += 128 * THREADS)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q));
}

template <int NW, int SL>
__global__ void __launch_bounds__(THREADS, 1)
    fused_ffn_kernel(const bf16* __restrict__ vals, const int* __restrict__ idx,
                     const int* __restrict__ nnz, const bf16* __restrict__ x,
                     const bf16* __restrict__ wu_t,
                     const bf16* __restrict__ wd, float* __restrict__ y,
                     int M, int K, int N, int T, int tc, int s_max, int nst,
                     int split) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const Layout L(NW, s_max, nst, N);
  uint8_t* htile = sm + L.h;
  float* part = reinterpret_cast<float*>(sm + L.part);
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
  uint32_t* lbits = reinterpret_cast<uint32_t*>(sm + L.lbits);
  int* pre = reinterpret_cast<int*>(sm + L.pre);
  uint16_t* cols = reinterpret_cast<uint16_t*>(sm + L.cols);
  int* u_s = reinterpret_cast<int*>(sm + L.u);
  int* tot = u_s + 4;  // [WARPS]
  uint32_t* flags32 = reinterpret_cast<uint32_t*>(sm);  // over the ring
  uint8_t* flags = sm;
  const int nwd = (N + 31) / 32;
  const uint32_t ring_a = smem_u32(sm), x_a = smem_u32(sm + L.x);
  const uint32_t h_a = smem_u32(htile);

  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();  // = blockIdx.x
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, wwarp = (tid % 128) / 32;
  const int g8 = lane / 4, c2 = (lane % 4) * 2;
  const int m0 = blockIdx.y * NW, rv = min(NW, M - m0);  // the block's rows
  const int nt = N / T, slots = nt * tc;
  const int nk = (K + BK - 1) / BK;
  // this rank's stages kb .. kb + ns - 1 of K; its 128-column slices of y
  const int kb = rank * nk / ks, ns = (rank + 1) * nk / ks - kb;
  const int nsl = (ns + 1) / 2;
  // this rank's rows of the scatter
  const int r_lo = rank * rv / ks, r_hi = (rank + 1) * rv / ks;

  // x's tile for this rank's stages on its way; the scatter's values to
  // L2; the byte map and the h tile cleared
  const int pairs = rv * nt;  // (row, tile) pairs of the block
  for (int i = tid; i < ns * NW * 8; i += THREADS) {
    const int s = i / (NW * 8), r = (i / 8) % NW, ch = i % 8;
    const int k = (kb + s) * BK + ch * 8;
    const bool ok = r < rv && k < K;
    cp_async16(x_a + s * NW * PANEL_ROW + sw128_off(r, ch),
               x + (ok ? (size_t)(m0 + r) * K + k : 0), ok);
  }
  cp_async_commit();
  prefetch_lines(vals + (size_t)(m0 + r_lo) * slots,
                 (size_t)(r_hi - r_lo) * slots * sizeof(bf16));
  for (int w = tid; w < 8 * nwd; w += THREADS) flags32[w] = 0u;
  for (int i = tid; i < (int)(2 * NW * PANEL_ROW / 16); i += THREADS)
    reinterpret_cast<uint4*>(htile)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // A tile's first 8 slots (one 32-byte sector of indices) are read in
  // the same round as its count; a slot at or past the count is ignored.
  // This thread's first pair of the rank's rows: those slots' columns and
  // gate values, kept in registers for the scatter
  const int mine = (r_hi - r_lo) * nt;
  const int* bnnz = nnz + (size_t)m0 * nt;
  int c0, col0[8];
  float g0[8];
  {
    const int r = r_lo + tid / nt, t = tid % nt;
    const bool ok = tid < mine;
    c0 = ok ? min(max(bnnz[r * nt + t], 0), tc) : 0;
    const size_t base = (size_t)(m0 + r) * slots + (size_t)t * tc;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      col0[q] = ok && q < tc ? idx[base + q] : -1;
      g0[q] = ok && q < tc ? __bfloat162float(vals[base + q]) : 0.f;
    }
  }
  // the union: each (row, tile)'s valid prefix of indices marked in the
  // byte map (every writer stores 1); all the block's rows, or with
  // `split` this rank's
  const int up_pairs = split ? mine : pairs, p_lo = split ? r_lo * nt : 0;
  twell_union::mark_prefixes<THREADS>(flags, idx + (size_t)m0 * slots, bnnz,
                                      p_lo, up_pairs, tc, N);
  // the kept slots are in registers now, not loaded again at their use
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    asm volatile("" : "+r"(col0[q]), "+f"(g0[q]));
    if (q >= c0) col0[q] = -1;
  }
  __syncthreads();
  // the bitmap, with `split` ORed over the ranks, its prefix popcount and
  // the union's columns
  TWELL_UNION_BUILD(U, THREADS, cluster, ks, split, flags32, bits, lbits, pre,
                    cols, u_s, tot, nwd, tid, warp, lane)

  const int nch = (U + UC - 1) / UC;
  const int per_c = ns + 2 * nsl;  // ring stages a chunk: up, then down
  const int total = nch * per_c;

  // ring stage jn: 128 rows of 64 bf16 gathered by union position, into
  // two 64-row panels. Up stage s of chunk c: W_u^T rows of positions
  // 128 c .. + 127 (panel = 64-position slab), k of stage kb + s. Down
  // stage v: W_d rows of positions 128 c + 64 (v % 2) .. + 63, y columns
  // of stages kb + 2 (v / 2) + panel. Zero past U, past K, past ns.
  auto issue = [&](int jn) {
    const int c = jn / per_c, u = jn % per_c;
    const bool up = u < ns;
    const int v = u - ns;
    const bf16* mat = up ? wu_t : wd;
    const uint32_t dst = ring_a + (jn % nst) * UNIT;
    const int ch = tid % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = tid / 8 + 32 * i, half = rr / 64, r64 = rr % 64;
      const int p = up ? c * UC + rr : c * UC + 64 * (v % 2) + r64;
      const int st = up ? u : 2 * (v / 2) + half;
      const int k = (kb + st) * BK + ch * 8;
      const int col = p < U ? (int)cols[p] : -1;
      const bool ok = col >= 0 && st < ns && k < K;
      cp_async16(dst + half * PANEL + sw128_off(r64, ch),
                 mat + (ok ? (size_t)col * K + k : 0), ok);
    }
  };
  // The stages are used a group at a time (a chunk's up stages, then its
  // down stages; a group is a phase where the ring holds one). Before
  // group [j0, j0 + g): every thread is done with the stages before j0 (a
  // barrier), their slots are refilled with the next stages (one copy
  // group a stage), then this thread's copies of the group have landed,
  // and every thread's (a barrier). `issued` is the same in every thread.
  int issued = 0;
  auto land = [&](int j0, int g) {
    __syncthreads();
    for (; issued < min(total, j0 + nst); ++issued) {
      issue(issued);
      cp_async_commit();
    }
    cp_async_wait_n(issued - (j0 + g));
    fence_proxy_async();
    __syncthreads();
  };
  // 8 slots of row r (this rank's) into h: for each whose column falls in
  // chunk c, bf16(h_u summed over the ranks x its gate value)
  auto put8 = [&](int c, int r, const int* col, const float* g) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if ((unsigned)col[q] >= (unsigned)N) continue;
      const int pc = twell_union::position(pre, bits, col[q]) - c * UC;
      if ((unsigned)pc >= (unsigned)UC) continue;
      *reinterpret_cast<bf16*>(htile + (pc / 64) * NW * PANEL_ROW +
                               r * PANEL_ROW +
                               (((pc % 64) * 2) ^ ((r & 7) << 4))) =
          __float2bfloat16_rn(part[r * PS + pc] * g[q]);
    }
  };

  // y^T accumulators: slice i, element 4n + 2h + e of this thread: y
  // column 16 wwarp + g8 + 8h of slab 2 i + wg of this rank's stages, row
  // 8n + c2 + e of the block
  float acc[SL][NW / 2];
#pragma unroll
  for (int i = 0; i < SL; ++i)
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < SL; ++i) fence_regs<NW / 2>(acc[i]);

  // A phase lands at once where the ring holds one (every plan up to K
  // 4096); past that (a rank of more than 8 stages) in groups of half the
  // ring: g_up up stages, g_sl slices' down stages a group
  const bool whole = nst >= 2 * ((s_max + 1) / 2);
  const int g_up = whole ? ns : max(1, nst / 2);
  const int g_sl = whole ? nsl : max(1, nst / 4);

  int j = 0;  // the next ring stage used
  for (int c = 0; c < nch; ++c) {
    // up: this rank's partial of h_u over the chunk, positions as wgmma M
    float hu[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) hu[e] = 0.f;
    fence_regs<NW / 2>(hu);
    for (int s0 = 0; s0 < ns; s0 += g_up) {
      const int g = min(g_up, ns - s0);
      land(j, g);
      for (int s = 0; s < g; ++s) {
        const uint32_t st = ring_a + ((j + s) % nst) * UNIT + wg * PANEL;
        const uint32_t xs = x_a + (s0 + s) * NW * PANEL_ROW;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          WgmmaKA<NW>::mma(hu, sw128_desc(st + kk * 32, 0),
                           sw128_desc(xs + kk * 32, 0));
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<NW / 2>(hu);
      j += g;
    }
    // D element 4n + 2h + e: position 64 wg + 16 wwarp + g8 + 8h of the
    // chunk, row 8n + c2 + e; stored as part[row][position]
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(8 * n + c2 + e) * PS + 64 * wg + 16 * wwarp + g8 + 8 * h] =
              hu[4 * n + 2 * h + e];
    cluster.sync();  // every rank's partials; every rank's copies of the
                     // previous chunk's h rows are done

    // this rank's rows of h_u: the ranks' partials summed in rank order
    // (16-byte pieces through DSMEM, every rank's load in flight before
    // the sums), into its own rows of the partial tile (no other rank
    // reads those); its rows of h zeroed
    for (int i = tid; i < (r_hi - r_lo) * (UC / 4); i += THREADS) {
      const int off = (r_lo + i / (UC / 4)) * PS + 4 * (i % (UC / 4));
      float4 v[MAX_KS];
#pragma unroll
      for (int rk = 0; rk < MAX_KS; ++rk)
        v[rk] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, rk < ks ? rk : 0) + off);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rk = 0; rk < MAX_KS; ++rk)
        if (rk < ks) {
          sum.x += v[rk].x;
          sum.y += v[rk].y;
          sum.z += v[rk].z;
          sum.w += v[rk].w;
        }
      *reinterpret_cast<float4*>(part + off) = sum;
    }
    for (int i = tid; i < 2 * (r_hi - r_lo) * 8; i += THREADS) {
      const int pnl = i / ((r_hi - r_lo) * 8), o = i % ((r_hi - r_lo) * 8);
      reinterpret_cast<uint4*>(htile + pnl * NW * PANEL_ROW +
                               r_lo * PANEL_ROW)[o] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    // each valid slot of this rank's rows whose column falls in the chunk
    // (the registers' first, then the rest)
    if (tid < mine) put8(c, r_lo + tid / nt, col0, g0);
    for (int p = tid; p < mine; p += THREADS) {
      const int r = r_lo + p / nt, t = p % nt;
      const size_t row = (size_t)(m0 + r);
      const int cnt = p == tid ? c0 : min(max(bnnz[p + r_lo * nt], 0), tc);
      const size_t base = row * slots + (size_t)t * tc;
      for (int j0 = p == tid ? 8 : 0; j0 < cnt; j0 += 8) {
        int col[8];
        float gv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool ok = j0 + q < cnt;
          col[q] = ok ? idx[base + j0 + q] : -1;
          gv[q] = ok ? __bfloat162float(vals[base + j0 + q]) : 0.f;
        }
        put8(c, r, col, gv);
      }
    }
    cluster.sync();  // every rank's rows of h are in place

    // the other ranks' rows of h, whole 128-byte rows (the swizzle stays
    // inside a row), 4 pieces a thread in flight
    for (int i0 = tid; i0 < 16 * rv; i0 += 4 * THREADS) {
      uint4 v[4];
      uint32_t off[4];
      int src[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a * THREADS, r = i / 16;
        const int owner = i < 16 * rv ? ((r + 1) * ks - 1) / rv : rank;
        off[a] = ((i % 16) / 8) * NW * PANEL_ROW + r * PANEL_ROW +
                 (i % 8) * 16;
        src[a] = owner;
        if (owner != rank)
          v[a] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(htile, owner) + off[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (src[a] != rank) *reinterpret_cast<uint4*>(htile + off[a]) = v[a];
    }
    fence_proxy_async();  // the h tile, for the async proxy (land's barrier)

    // down: 128 y columns a slice, the chunk's two 64-position halves;
    // slices i0 .. i1 - 1 a group
    for (int i0 = 0; i0 < nsl; i0 += g_sl) {
      const int i1 = min(nsl, i0 + g_sl);
      land(j, 2 * (i1 - i0));
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        if (i >= i0 && i < i1) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint32_t st =
                ring_a + ((j + 2 * (i - i0) + q) % nst) * UNIT + wg * PANEL;
            const uint32_t hs = h_a + q * NW * PANEL_ROW;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              WgmmaTA<NW>::mma(acc[i],
                               sw128_desc(st + kk * 16 * PANEL_ROW, PANEL),
                               sw128_desc(hs + kk * 32, 0));
            wgmma_commit();
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < SL; ++i) fence_regs<NW / 2>(acc[i]);
      j += 2 * (i1 - i0);
    }
  }
  cp_async_wait<0>();

  // y: this warpgroup's slabs 2 i + wg of this rank's stages
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    const int slab = 2 * i + wg;
    if (slab < ns) {
      const int k0 = (kb + slab) * BK + 16 * wwarp + g8;
#pragma unroll
      for (int n = 0; n < NW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + c2 + e;
          if (r < rv) {
            float* dst = y + (size_t)(m0 + r) * K;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (k0 + 8 * h < K) dst[k0 + 8 * h] = acc[i][4 * n + 2 * h + e];
          }
        }
    }
  }
  // no block leaves while another reads its shared memory
  if (nch > 0 || split) cluster.sync();
}

template <int NW, int SL>
int configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid,
              int ks, size_t smem, cudaStream_t stream) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ffn_kernel<NW, SL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

struct Args {
  const void *vals, *idx, *nnz, *x, *wu_t, *wd;
  void* y;
  int M, K, N, T, tc, s_max, nst, ks, split;
  size_t smem;
  cudaStream_t stream;
};

template <int NW, int SL>
int launch(const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<NW, SL>(&cfg, &attr,
                                  dim3(a.ks, (a.M + NW - 1) / NW, 1), a.ks,
                                  a.smem, a.stream);
  if (e) return e;
  cudaError_t ce = cudaLaunchKernelEx(
      &cfg, fused_ffn_kernel<NW, SL>, (const bf16*)a.vals, (const int*)a.idx,
      (const int*)a.nnz, (const bf16*)a.x, (const bf16*)a.wu_t,
      (const bf16*)a.wd, (float*)a.y, a.M, a.K, a.N, a.T, a.tc, a.s_max,
      a.nst, a.split);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

template <int NW, int SL>
int resident(int ks, size_t smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<NW, SL>(&cfg, &attr, dim3(ks, 64, 1), ks, smem, 0);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveClusters(out, fused_ffn_kernel<NW, SL>,
                                             &cfg);
}

// the (width, slices) pairs built: the accumulators of both products,
// (slices + 1) x width / 2 floats a thread, stay within 128; 6 and 8
// slices only past K 4096, 16 only past K 8192
#define FUSED_FFN_CONFIGS(X)                                           \
  X(8, 2) X(8, 4) X(16, 2) X(16, 4) X(32, 2) X(32, 4) X(64, 2) X(8, 6) \
  X(16, 6) X(32, 6) X(8, 8) X(16, 8) X(8, 16)

// checks the launch, its shared memory into *smem; 0 or a cudaError_t
int plan_smem(int M, int K, int N, int T, int C, int width, int ks,
              int stages, size_t* smem, int* s_max) {
  if (ks < 1 || ks > MAX_KS || stages < 2 || stages > MAX_STAGES || M < 1 ||
      K < 1 || K % 8 || C < 1 || T < 1 || T % C || N < T || N % T ||
      N >= 65536)
    return (int)cudaErrorInvalidValue;
  const int nk = (K + BK - 1) / BK;
  if (ks > nk) return (int)cudaErrorInvalidValue;
  *s_max = (nk + ks - 1) / ks;
  if (staging_bytes(N) > (uint32_t)stages * UNIT)
    return (int)cudaErrorInvalidValue;
  *smem = 1024 + Layout(width, *s_max, stages, N).end;
  return *smem > SMEM_MAX ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// vals/idx (M, N/C) bf16/int32, nnz (M, N/T) int32 (clipped to T/C; the
// kernel reads no slot at or past it), x (M, K) bf16, wu_t (N, K) bf16
// (= W_u transposed), wd (N, K) bf16, all contiguous; x, wu_t and wd
// 16-byte aligned; y (M, K) float32. Requires K % 8 == 0, N % T == 0,
// T % C == 0, N < 65536. width (rows a block: 8, 16, 32 or 64), slices
// (128-column slices of y a rank holds: 2, 4, 6, 8 or 16, at least half
// the rank's stages; K up to 16384 at ks 8), ks (blocks a cluster, 1..8, at
// most K's 64-deep stages), stages (ring depth, 2..8; below a phase, the
// rank's stages rounded up to even, a phase lands in groups) and split (1: each rank marks only its rows' columns and the
// ranks OR their bitmaps through DSMEM; 0: each rank marks all the block's)
// are the host plan's (kernels/sparse_ffn.py: fused_ffn_plan).
extern "C" int twell_fused_ffn_bf16(const void* vals, const void* idx,
                                    const void* nnz, const void* x,
                                    const void* wu_t, const void* wd, void* y,
                                    int M, int K, int N, int T, int C,
                                    int width, int slices, int ks, int stages,
                                    int split, void* stream) {
  Args a{vals, idx, nnz, x, wu_t, wd, y, M, K, N, T, T / (C > 0 ? C : 1), 0,
         stages, ks, split != 0, 0, (cudaStream_t)stream};
  const int e = plan_smem(M, K, N, T, C, width, ks, stages, &a.smem,
                          &a.s_max);
  if (e) return e;
  if ((a.s_max + 1) / 2 > slices) return (int)cudaErrorInvalidValue;
#define FUSED_FFN_LAUNCH(NW, SL) \
  if (width == NW && slices == SL) return launch<NW, SL>(a);
  FUSED_FFN_CONFIGS(FUSED_FFN_LAUNCH)
#undef FUSED_FFN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// *clusters = how many clusters of ks blocks of the launch (width, slices,
// stages) at (K, N, T) fit on the card at once
// (cudaOccupancyMaxActiveClusters), *smem = a block's dynamic shared
// memory. For measuring launch plans; the kernel path does not call it.
extern "C" int twell_fused_ffn_resident_clusters(int K, int N, int T,
                                                 int width, int slices,
                                                 int ks, int stages,
                                                 int* clusters, int* smem) {
  size_t bytes = 0;
  int s_max = 0;
  const int e = plan_smem(1, K, N, T, 1, width, ks, stages, &bytes, &s_max);
  if (e) return e;
  *smem = (int)bytes;
#define FUSED_FFN_RESIDENT(NW, SL) \
  if (width == NW && slices == SL) return resident<NW, SL>(ks, bytes, clusters);
  FUSED_FFN_CONFIGS(FUSED_FFN_RESIDENT)
#undef FUSED_FFN_RESIDENT
  return (int)cudaErrorInvalidValue;
}
