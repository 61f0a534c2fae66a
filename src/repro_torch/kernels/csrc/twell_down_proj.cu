// K6: the non-gated TwELL down projection (paper App. C.2, Listing 3).
//
// Replaces src/repro/kernels/sparse_ffn.py:105 twell_down_proj_pallas (its
// _down_kernel at :80):   y = unpack(h) @ W_d,  f32 out, where the up
// projection itself produced the TwELL pattern (h = act(x @ W_u), kernel
// K1). As a sum over the row's valid slots:
//   y[m, :] = sum_t sum_{s < nnz[m, t]} float(vals[m, t*tc + s])
//                                       * float(W_d[idx[m, t*tc + s], :])
//
// What bounds it on the H100: at olmo-1b's shape (K 2048, N 8192, T 256,
// C 8, ~2% of the W_u columns alive) a row block's union of valid columns
// is ~150-170, so the bytes a call must move are the valid prefixes of the
// packed values, indices and counts, each distinct W_d row once (~0.7 MB)
// and y in f32: 0.2 us at M 4 and 1 us at M 256 at 3.35 TB/s. The products
// over the union padded to 128 are tiny. So the kernel is fixed cost and
// latency: it must read each W_d row once a row block, spread those reads
// over many SMs and keep its chain of dependent rounds short. (The first
// version took a block per (row, 256-column slice of y): each of a row's 8
// blocks redid the row's prefix sum and compaction, every W_d row a slot
// named was read once a row, and the product ran on CUDA cores one
// dependent 16-byte load a slot a lane.)
//
// Design (primitives from sm90_common.cuh; the union from twell_union.cuh,
// shared with K2; this is K2's down half without the up product):
//   * grid (column blocks, row blocks) of NW rows (M rounded up to 8, 16,
//     32 or 64). Column block b owns y's 64-column stages 2 SL b .. 2 SL b
//     + 2 SL - 1 (SL slices of 128 columns), a 64-column slab a warpgroup.
//     NW, SL, the cluster size, the ring depth and the chunks of h held
//     come from the host plan (kernels/sparse_ffn.py: down_proj_plan, from
//     shapes and the SM count): a decode call (M 4, K 2048) spreads over 16
//     blocks;
//   * the union of the block's rows, built on the card (twell_union.cuh).
//     From 32 rows a block the column blocks of a row block form clusters
//     of up to 8 (`split`): each rank marks its share of the rows and the
//     ranks OR their bitmaps through DSMEM;
//   * h is `vals` itself (bf16): the valid slots whose union position
//     falls in the chunks held (HC chunks of UC = 128 positions) go into
//     an h tile (NW rows x 128 positions a chunk, K-major, 128B-swizzled,
//     zero elsewhere). A row's valid slots hold distinct columns (each
//     column lies in one tile, and K1 writes each non-zero once), so each
//     h entry gets at most one write. A rank scatters the rows it marked:
//     with `split` its share, whose h rows the other ranks then copy whole
//     through DSMEM (every block scattering all 64 rows was 1.4x slower at
//     256 rows on the H100). Eight lanes read a (row, tile) pair's
//     slots, lane q slot q (+ 8, + 16, ... up to the count), so a warp's
//     loads touch 4 pairs' sectors, not 32; a thread keeps 4 or 8 pairs'
//     loads in flight (a batch), and the first batch is read in the same
//     round as the union's indices and kept in registers for the first
//     scatter. No integer division on the card: a pair's slots start at
//     pair x tc, and its row is a multiply-high by a reciprocal (from the
//     host for the first scan). Positions ascend with columns, so a later
//     group of chunks (a union wider than the h tile) scans only the tiles
//     its columns lie in;
//   * the union's W_d rows gathered by cp.async into a ring of 16 KB stages
//     (64 union positions x 128 y columns, 16-byte pieces, 128B-swizzled,
//     zero past U and past K; TMA has no gather), issued as soon as the
//     union's columns are known and refilled as far ahead as the ring
//     holds, so the rows land while the scatter and the products run. (An
//     L2 prefetch of each marked column's row while marking made the
//     kernel slower on the H100.) The byte map of N is staged over the
//     ring before it starts;
//   * products: y^T[cols, rows] += W_d^T[cols, U_c] h^T[U_c, rows] on
//     wgmma m64nNWk16, swap-AB (WgmmaTA): A = the chunk's W_d rows read
//     MN-major (each row 64 y columns), B = the h tile, K-major. The
//     accumulators persist over the chunks (a scattered union loops);
//   * y is stored straight from the accumulators: each element has one
//     writer and a fixed summation order, so a repeated call gives the same
//     bits. A row block whose union is empty writes its zeros.
// Every branch around a wgmma depends only on values uniform over the
// block (U, the block's stages, the chunk counter); zeroed accumulators
// are fenced (fence_regs).
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
constexpr int BK = 64;                    // y columns of a slab
constexpr int UC = 128;                   // union positions a chunk
constexpr uint32_t PANEL = 64 * PANEL_ROW;  // 64 rows x 128 bytes
constexpr uint32_t UNIT = 2 * PANEL;      // a ring stage: two panels
constexpr int MAX_STAGES = 8;             // ring depth
constexpr int MAX_HC = 2;                 // union chunks the h tile holds
constexpr int LP = 8;                     // lanes a (row, tile) pair: lane q
//                                           reads slot q (coalesced)
constexpr int PS = THREADS / LP;          // pairs a step
constexpr size_t SMEM_MAX = 232448;       // a block's shared memory

// Byte offsets in the 1024-aligned dynamic shared memory of a block of NW
// rows, an h tile of hc chunks, a ring of nst stages and N columns
// (kernels/sparse_ffn.py: down_proj_smem computes the same end + 1 KB).
// The byte map of N is staged over the ring before it starts.
struct Layout {
  uint32_t h, bits, lbits, pre, cols, u, end;
  __host__ __device__ Layout(int nw, int hc, int nst, int n) {
    const uint32_t nwd = (n + 31) / 32;
    h = nst * UNIT;                        // [hc][2] panels of NW rows
    bits = h + hc * 2 * nw * PANEL_ROW;    // u32 [nwd]
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

template <int NW, int SL>
__global__ void __launch_bounds__(THREADS, 1)
    down_proj_kernel(const bf16* __restrict__ vals,
                     const int* __restrict__ idx, const int* __restrict__ nnz,
                     const bf16* __restrict__ wd, float* __restrict__ y,
                     int M, int K, int N, int T, int tc, uint32_t nt_inv,
                     int hc, int nst, int split) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const Layout L(NW, hc, nst, N);
  uint8_t* htile = sm + L.h;
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
  uint32_t* lbits = reinterpret_cast<uint32_t*>(sm + L.lbits);
  int* pre = reinterpret_cast<int*>(sm + L.pre);
  uint16_t* cols = reinterpret_cast<uint16_t*>(sm + L.cols);
  int* u_s = reinterpret_cast<int*>(sm + L.u);
  int* tot = u_s + 4;  // [WARPS]
  uint32_t* flags32 = reinterpret_cast<uint32_t*>(sm);  // over the ring
  const int nwd = (N + 31) / 32;
  const uint32_t ring_a = smem_u32(sm), h_a = smem_u32(htile);
  constexpr uint32_t HCHUNK = 2 * NW * PANEL_ROW;  // a chunk's h tile

  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, wwarp = (tid % 128) / 32;
  const int g8 = lane / 4, c2 = (lane % 4) * 2;
  const int m0 = blockIdx.y * NW, rv = min(NW, M - m0);  // the block's rows
  const int nt = N / T, slots = nt * tc;
  const int nk = (K + BK - 1) / BK;
  // this block's stages kb .. kb + ns - 1 of y; its 128-column slices
  const int kb = blockIdx.x * 2 * SL, ns = min(2 * SL, nk - kb);
  const int nsl = (ns + 1) / 2;
  const int* bnnz = nnz + (size_t)m0 * nt;
  const int* bidx = idx + (size_t)m0 * slots;
  const uint16_t* bvals =
      reinterpret_cast<const uint16_t*>(vals) + (size_t)m0 * slots;

  // A scan of tiles [t0, t0 + ntg) of rows [r0, r0 + rows) of the block:
  // pair pp is row r0 + pp / ntg (a multiply by inv = ceil(2^32 / ntg):
  // exact below 2^16), tile t0 + pp % ntg; the slots of (row r, tile t)
  // start at (r nt + t) tc. Batch b: pairs b BATCH + tid / LP + PS i (i <
  // UNR), slot q8 = tid % LP of each: the count, clipped to [0, tc], and
  // slot q8's column and value (-1 past tc), all in flight at once: 4
  // steps at 8 rows a block (a decode call's 4 rows of 32 tiles in one
  // batch), else 8 (a rank's 8 rows of 64 split 8 ways).
  constexpr int UNR = NW == 8 ? 4 : 8;
  constexpr int BATCH = PS * UNR;
  const int q8 = tid % LP;
  struct Scan {
    int r0, rows, t0, ntg;
    uint32_t inv;
  };
  auto row_of = [&](const Scan& sc, int pp) {
    return sc.r0 + (sc.ntg == 1 ? pp : (int)__umulhi((uint32_t)pp, sc.inv));
  };
  auto pair_of = [&](const Scan& sc, int pp, int r) {
    return r * nt + sc.t0 + pp - (r - sc.r0) * sc.ntg;
  };
  auto load = [&](const Scan& sc, int b, int* cnt, int* col, uint16_t* v) {
#pragma unroll
    for (int i = 0; i < UNR; ++i) {
      const int pp = b * BATCH + tid / LP + PS * i;
      const bool ok = pp < sc.rows * sc.ntg;
      const int p = pair_of(sc, pp, row_of(sc, pp));
      cnt[i] = ok ? min(max(bnnz[p], 0), tc) : 0;
      const size_t at = (size_t)p * tc + q8;
      col[i] = ok && q8 < tc ? bidx[at] : -1;
      v[i] = ok && q8 < tc ? bvals[at] : (uint16_t)0;
    }
  };
  // This rank's rows: all the block's, or with `split` its share. It
  // marks their columns in the union and scatters their slots into h;
  // with `split` the other ranks' rows of h come through DSMEM. The byte
  // map and the h tile cleared
  const int r_lo = split ? rank * rv / ks : 0;
  const int r_hi = split ? (rank + 1) * rv / ks : rv;
  const Scan mine{r_lo, r_hi - r_lo, 0, nt, nt_inv};
  int kcnt[UNR], kcol[UNR];
  uint16_t kv[UNR];
  twell_union::clear_flags<THREADS>(flags32, nwd);
  for (int i = tid; i < (int)(hc * HCHUNK / 16); i += THREADS)
    reinterpret_cast<uint4*>(htile)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // the union, with the first batch's loads in flight beside its own
  load(mine, 0, kcnt, kcol, kv);
  twell_union::mark_prefixes<THREADS>(sm, bidx, bnnz, r_lo * nt,
                                      (r_hi - r_lo) * nt, tc, N);
  // the kept slots are in registers now, not loaded again at their use
#pragma unroll
  for (int i = 0; i < UNR; ++i)
    asm volatile("" : "+r"(kcol[i]), "+h"(kv[i]), "+r"(kcnt[i]));
  __syncthreads();
  TWELL_UNION_BUILD(U, THREADS, cluster, ks, split, flags32, bits, lbits, pre,
                    cols, u_s, tot, nwd, tid, warp, lane)
  __syncthreads();  // the union's columns; the byte map freed

  const int nch = (U + UC - 1) / UC;
  const int per_c = 2 * nsl;  // ring stages a chunk
  const int total = nch * per_c;

  // Ring stage v of chunk c (into ring slot `slot`): the W_d rows of union
  // positions 128 c + 64 (v % 2) .. + 63, y columns of stages kb + 2 (v /
  // 2) + panel (a panel a warpgroup). Zero past U, past K, past ns.
  auto issue = [&](int c, int v, int slot) {
    const uint32_t dst = ring_a + slot * UNIT;
    const int ch = tid % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = tid / 8 + 32 * i, half = rr / 64, r64 = rr % 64;
      const int p = c * UC + 64 * (v % 2) + r64;
      const int st = 2 * (v / 2) + half;
      const int k = (kb + st) * BK + ch * 8;
      const int col = p < U ? (int)cols[p] : -1;
      const bool ok = col >= 0 && st < ns && k < K;
      cp_async16(dst + half * PANEL + sw128_off(r64, ch),
                 wd + (ok ? (size_t)col * K + k : 0), ok);
    }
  };
  // the stages issued so far (the next one's chunk, stage and ring slot):
  // the same in every thread
  int issued = 0, ic = 0, iv = 0, islot = 0;
  auto issue_to = [&](int upto) {
    for (; issued < upto; ++issued) {
      issue(ic, iv, islot);
      cp_async_commit();
      if (++iv == per_c) iv = 0, ++ic;
      if (++islot == nst) islot = 0;
    }
  };
  // Before chunk [j0, j0 + g): every thread is done with the stages
  // before j0 (a barrier), their slots are refilled with the next stages
  // (one copy group a stage), then this thread's copies of the chunk have
  // landed, and every thread's (a barrier).
  auto land = [&](int j0, int g) {
    __syncthreads();
    issue_to(min(total, j0 + nst));
    cp_async_wait_n(issued - (j0 + g));
    fence_proxy_async();
    __syncthreads();
  };
  // a slot of row r whose union position falls in [lo, lo + hc UC), into
  // the h tile
  auto put = [&](int r, int lo, int col, uint16_t v) {
    const unsigned pc = (unsigned)(twell_union::position(pre, bits, col) - lo);
    if (pc >= (unsigned)(hc * UC)) return;
    const unsigned pp = pc % UC;
    *reinterpret_cast<uint16_t*>(htile + (pc / UC) * HCHUNK +
                                 (pp / 64) * NW * PANEL_ROW + r * PANEL_ROW +
                                 (((pp % 64) * 2) ^ ((r & 7) << 4))) = v;
  };
  // the valid slots of batch b of a scan (slot q8 of each pair in cnt,
  // col, v; the later slots q8 + 8, + 16, ... read here, every pair's in
  // flight)
  auto scatter_batch = [&](const Scan& sc, int b, int lo, const int* cnt,
                           const int* col, const uint16_t* v) {
    int most = 0;
#pragma unroll
    for (int i = 0; i < UNR; ++i) {
      const int pp = b * BATCH + tid / LP + PS * i;
      if (q8 < cnt[i] && (unsigned)col[i] < (unsigned)N)
        put(row_of(sc, pp), lo, col[i], v[i]);
      most = max(most, cnt[i]);
    }
    for (int s0 = LP; s0 < most; s0 += LP) {
      int cm[UNR];
      uint16_t vm[UNR];
#pragma unroll
      for (int i = 0; i < UNR; ++i) {
        const int pp = b * BATCH + tid / LP + PS * i;
        const bool ok = s0 + q8 < cnt[i];
        const size_t at =
            (size_t)pair_of(sc, pp, row_of(sc, pp)) * tc + s0 + q8;
        cm[i] = ok ? bidx[at] : -1;
        vm[i] = ok ? bvals[at] : (uint16_t)0;
      }
#pragma unroll
      for (int i = 0; i < UNR; ++i)
        if ((unsigned)cm[i] < (unsigned)N)
          put(row_of(sc, b * BATCH + tid / LP + PS * i), lo, cm[i], vm[i]);
    }
  };
  // every valid slot of the scan whose position falls in [lo, lo + hc
  // UC), batches from `from` on read here
  auto scatter = [&](const Scan& sc, int lo, int from) {
    for (int b = from; b * BATCH < sc.rows * sc.ntg; ++b) {
      int cnt[UNR], col[UNR];
      uint16_t v[UNR];
      load(sc, b, cnt, col, v);
      scatter_batch(sc, b, lo, cnt, col, v);
    }
  };
  // With `split`, once every rank's rows are in place (a cluster barrier):
  // the other ranks' rows of the tile's first `chunks` chunks, whole
  // 128-byte rows (the swizzle stays inside a row), from their owners
  // through DSMEM, 4 pieces a thread in flight; then this rank arrives on
  // the barrier that keeps its tile until every rank has copied from it
  auto share = [&](int chunks) {
    if (!split) return;
    cluster.sync();
    const int pieces = 2 * chunks * rv * 8;  // (panel, row, 16 bytes)
    for (int i0 = tid; i0 < pieces; i0 += 4 * THREADS) {
      uint4 v[4];
      uint32_t off[4];
      int src[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a * THREADS, pr = i / 8;
        const int pnl = pr / rv, r = pr - pnl * rv;
        src[a] = i < pieces ? ((r + 1) * ks - 1) / rv : rank;
        off[a] = pnl * NW * PANEL_ROW + r * PANEL_ROW + (i % 8) * 16;
        if (src[a] != rank)
          v[a] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(htile, src[a]) + off[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (src[a] != rank) *reinterpret_cast<uint4*>(htile + off[a]) = v[a];
    }
    cluster_arrive();
  };

  // the W_d rows of the first chunks on their way, then the first hc
  // chunks of h (the kept batch first)
  issue_to(min(total, nst));
  scatter_batch(mine, 0, 0, kcnt, kcol, kv);
  scatter(mine, 0, 1);
  share(min(hc, nch));
  fence_proxy_async();  // the h tile, for the async proxy (land's barrier)

  // y^T accumulators: slice i, element 4n + 2h + e of this thread: y
  // column 16 wwarp + g8 + 8h of slab 2 i + wg of this block's stages,
  // row 8n + c2 + e of the block
  float acc[SL][NW / 2];
#pragma unroll
  for (int i = 0; i < SL; ++i)
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < SL; ++i) fence_regs<NW / 2>(acc[i]);

  int j = 0, jslot = 0;  // the next ring stage used, and its slot
  for (int c = 0, held = 0; c < nch; ++c, ++held) {
    if (held == hc) {
      // the next hc chunks of h, once both warpgroups are done with the
      // tile (each waited on its own products) and every rank has copied
      // this rank's rows. Positions ascend with columns, so they come only
      // from the tiles of the chunks' columns
      held = 0;
      const int t0 = cols[c * UC] / T;
      const int ntg = cols[min(c * UC + hc * UC, U) - 1] / T - t0 + 1;
      const Scan sc{r_lo, r_hi - r_lo, t0, ntg,
                    (uint32_t)((0x100000000ull + ntg - 1) / ntg)};
      if (split) cluster_wait();
      __syncthreads();
      const int own = (r_hi - r_lo) * 8;  // this rank's rows, 16-byte pieces
      for (int i = tid; i < 2 * hc * own; i += THREADS)
        reinterpret_cast<uint4*>(htile + (i / own) * NW * PANEL_ROW +
                                 r_lo * PANEL_ROW)[i % own] =
            make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      scatter(sc, c * UC, 0);
      share(min(hc, nch - c));
      fence_proxy_async();
    }
    // 128 y columns a slice, the chunk's two 64-position halves
    land(j, per_c);
    const uint32_t hc_a = h_a + held * HCHUNK;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      if (i < nsl) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          int s = jslot + 2 * i + q;
          if (s >= nst) s -= nst;
          const uint32_t st = ring_a + s * UNIT + wg * PANEL;
          const uint32_t hs = hc_a + q * NW * PANEL_ROW;
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
    j += per_c;
    jslot += per_c;
    if (jslot >= nst) jslot -= nst;
  }
  cp_async_wait<0>();

  // y: this warpgroup's slabs 2 i + wg of this block's stages
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
  if (split) cluster_wait();
}

template <int NW, int SL>
int configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid,
              int ks, size_t smem, cudaStream_t stream) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      down_proj_kernel<NW, SL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  const void *vals, *idx, *nnz, *wd;
  void* y;
  int M, K, N, T, tc, hc, nst, ks, split, col_blocks;
  uint32_t nt_inv;  // ceil(2^32 / (N / T)): the kernel's row of a pair
  size_t smem;
  cudaStream_t stream;
};

template <int NW, int SL>
int launch(const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<NW, SL>(
      &cfg, &attr, dim3(a.col_blocks, (a.M + NW - 1) / NW, 1), a.ks, a.smem,
      a.stream);
  if (e) return e;
  cudaError_t ce = cudaLaunchKernelEx(
      &cfg, down_proj_kernel<NW, SL>, (const bf16*)a.vals, (const int*)a.idx,
      (const int*)a.nnz, (const bf16*)a.wd, (float*)a.y, a.M, a.K, a.N, a.T,
      a.tc, a.nt_inv, a.hc, a.nst, a.split);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

template <int NW, int SL>
int resident(int ks, size_t smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<NW, SL>(&cfg, &attr, dim3(ks, 64, 1), ks, smem, 0);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveClusters(out, down_proj_kernel<NW, SL>,
                                             &cfg);
}

// the (width, slices) pairs built: the accumulators, slices x width / 2
// floats a thread, stay within 128
#define DOWN_PROJ_CONFIGS(X) \
  X(8, 1) X(8, 2) X(8, 4) X(16, 1) X(16, 2) X(16, 4) X(32, 1) X(32, 2) \
  X(32, 4) X(64, 1) X(64, 2) X(64, 4)

// checks the launch; its shared memory into *smem and its column blocks
// (a multiple of ks) into *col_blocks; 0 or a cudaError_t
int plan_smem(int M, int K, int N, int T, int C, int width, int slices,
              int ks, int stages, int hc, size_t* smem, int* col_blocks) {
  if (ks < 1 || ks > MAX_KS || stages < 2 * slices || stages < 2 ||
      stages > MAX_STAGES || hc < 1 || hc > MAX_HC || M < 1 || K < 1 ||
      K % 8 || C < 1 || T < 1 || T % C || N < T || N % T || N >= 65536)
    return (int)cudaErrorInvalidValue;
  const int nk = (K + BK - 1) / BK;
  *col_blocks = (nk + 2 * slices - 1) / (2 * slices);
  if (*col_blocks % ks) return (int)cudaErrorInvalidValue;
  if (staging_bytes(N) > (uint32_t)stages * UNIT)
    return (int)cudaErrorInvalidValue;
  *smem = 1024 + Layout(width, hc, stages, N).end;
  return *smem > SMEM_MAX ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// vals (M, N/C) bf16, idx (M, N/C) int32, nnz (M, N/T) int32 (clipped to
// T/C; the kernel reads no slot at or past it), wd (N, K) bf16, all
// contiguous, wd 16-byte aligned; y (M, K) float32. Requires K % 8 == 0,
// N % T == 0, T % C == 0, N < 65536. width (rows a block: 8, 16, 32 or
// 64), slices (128-column slices of y a block: 1, 2 or 4), ks (blocks a
// cluster, 1..8, dividing the column blocks), stages (ring depth, 2..8, at
// least 2 x slices), h_chunks (union chunks the h tile holds, 1..2) and
// split (1: each rank marks only its rows' columns and the ranks OR their
// bitmaps through DSMEM) are the host plan's (kernels/sparse_ffn.py:
// down_proj_plan).
extern "C" int twell_down_proj_bf16(const void* vals, const void* idx,
                                    const void* nnz, const void* wd, void* y,
                                    int M, int K, int N, int T, int C,
                                    int width, int slices, int ks, int stages,
                                    int h_chunks, int split, void* stream) {
  Args a{vals, idx, nnz, wd, y, M, K, N, T, T / (C > 0 ? C : 1), h_chunks,
         stages, ks, split != 0, 0, 0, 0, (cudaStream_t)stream};
  const int e = plan_smem(M, K, N, T, C, width, slices, ks, stages, h_chunks,
                          &a.smem, &a.col_blocks);
  if (e) return e;
  const uint64_t nt = N / T;
  a.nt_inv = (uint32_t)(((1ull << 32) + nt - 1) / nt);
#define DOWN_PROJ_LAUNCH(NW, SL) \
  if (width == NW && slices == SL) return launch<NW, SL>(a);
  DOWN_PROJ_CONFIGS(DOWN_PROJ_LAUNCH)
#undef DOWN_PROJ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// *clusters = how many clusters of ks blocks of the launch (width, slices,
// stages, h_chunks) at (K, N, T) fit on the card at once
// (cudaOccupancyMaxActiveClusters), *smem = a block's dynamic shared
// memory. For measuring launch plans; the kernel path does not call it.
extern "C" int twell_down_proj_resident_clusters(int K, int N, int T,
                                                 int width, int slices,
                                                 int ks, int stages,
                                                 int h_chunks, int* clusters,
                                                 int* smem) {
  size_t bytes = 0;
  int col_blocks = 0;
  const int e = plan_smem(1, K, N, T, 1, width, slices, ks, stages, h_chunks,
                          &bytes, &col_blocks);
  if (e) return e;
  *smem = (int)bytes;
#define DOWN_PROJ_RESIDENT(NW, SL) \
  if (width == NW && slices == SL) return resident<NW, SL>(ks, bytes, clusters);
  DOWN_PROJ_CONFIGS(DOWN_PROJ_RESIDENT)
#undef DOWN_PROJ_RESIDENT
  return (int)cudaErrorInvalidValue;
}
