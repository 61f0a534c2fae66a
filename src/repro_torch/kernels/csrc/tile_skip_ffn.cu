// K5: gated FFN end to end with (row block x hidden tile) skipping.
//
// Replaces src/repro/kernels/sparse_ffn.py:159 tile_skip_ffn_pallas (its
// body _kernel_gated_dense_gate, :130), extended by the per-(row, tile)
// threshold of src/repro/kernels/ref.py:33 tile_skip_ffn:
//   g  = act(x @ W_g)                       f32, act = relu | relu^2
//   row m drops tile j when max g[m, tile j] <= threshold (g >= 0; at
//   threshold 0 that is the Pallas predicate jnp.any(g > 0))
//   hu = x @ W_u[:, tile]                   f32
//   h  = bf16(hu * g)                       rounded once, as the Pallas body;
//                                           0 on the rows that drop the tile
//   y  = sum over the kept tiles, in tile order, of h @ W_d[tile, :]   f32
// and flags (ceil(M/32), N/T) int32: 1 where some valid row of the 32-row
// group keeps the tile.
//
// What bounds it on the H100: bytes. Every call reads all of W_g (23.1 MB
// per paper-0.5b layer, 6.9 us at 3.35 TB/s); each tile some row keeps
// adds its slices of W_u and W_d (2 x 1 MB). At decode (M <= 4, the
// speculative drafts) the products are negligible beside that; at a
// 256-row chunk the 17.7 GFLOP of three full products still take less
// time than the 69 MB of weights, on wgmma.
//
// Design: two kernels, both the swap-AB product of K1 (twell_pack.cu) on
// sm90_common.cuh. A block computes D^T = W_box^T B^T: COLS output columns
// as wgmma's M (COLS/64 slabs of m64 over one or two consumer warpgroups),
// its rows of B as wgmma's N (M rounded up to 8/16/32/64/128). A = the W
// box read MN-major (the transpose bit; W is never transposed), B = the
// activation box, K-major. One producer warp issues TMA into a ring of
// 64-deep stages with full and empty mbarriers; the reduction is split over
// a cluster of ks blocks in whole stages; each rank stores its f32 partial
// [row][column] over the ring, and after a cluster barrier rank r sums its
// share of the rows over all ranks in rank order through distributed shared
// memory (the same bits every run, no atomics on floats).
//   * up (one cluster per (T-column tile, row block); W = W_g, then W_u;
//     B = x): phase 1 reduces g = act(x @ W_g) for the rank's rows, keeps
//     them (a warp's first row in registers, the rest in shared memory,
//     outside the ring) and sets each row's keep bit; every rank pushes its
//     keep bits to every rank, and after a second cluster barrier the
//     decision "some row of the block keeps the tile" is one value in every
//     thread of the cluster (__syncthreads_or), so every branch on it is
//     uniform and the wgmmas stay asynchronous. Rank 0 writes the 32-row
//     groups' flags. Phase 2 runs only on a kept tile: the producer refills
//     the ring with W_u boxes (the ring's counters go on from phase 1), the
//     same split K loop runs, and each rank writes h = bf16(hu * g) for its
//     rows. A skipped tile never reads W_u and writes zeros to h.
//   * down (one cluster per (COLS columns of y, row block); W = W_d, which
//     is (N, K) row-major: the reduction runs down its rows and y's columns
//     along them, the layout WgmmaTA reads MN-major; B = h): the block lists
//     the kept tiles of its row block from the flags (ORed over its 32-row
//     groups) and the cluster splits their 64-deep stages, in tile order;
//     a rank with none adds zeros and still meets the barriers. It is
//     launched with programmatic dependent launch: its blocks start as the
//     up kernel's leave, and wait for the whole up grid (griddep_wait)
//     before reading the flags.
// Rows past M are zero-filled by TMA and never written. The launch plan
// (rows a block, ks, ring depth, COLS, the g rows a rank keeps in shared
// memory) is the host's: kernels/sparse_ffn.py tile_skip_plan, one wave of
// resident clusters, two blocks an SM at widths up to 32.
#include <cooperative_groups.h>

#include <mutex>

#include "sm90_common.cuh"

namespace cg = cooperative_groups;
using namespace sm90;

namespace {

constexpr int BK = 64;                     // depth of a stage
constexpr uint32_t SLAB = BK * PANEL_ROW;  // one W box: 64 deep x 64 columns
constexpr int MAX_KS = 8;                  // portable cluster size
constexpr size_t SMEM_MAX = 232448;        // a block's shared memory

// a block of D^T = W^T B^T: COLS output columns by NW rows of B
template <int COLS, int NW>
struct Cfg {
  static constexpr int CWG = COLS == 64 ? 1 : 2;     // consumer warpgroups
  static constexpr int SPW = COLS / 64 / CWG;        // slabs per warpgroup
  static constexpr int THREADS = CWG * 128 + 32;     // + the producer warp
  static constexpr int WARPS = THREADS / 32;
  static constexpr int HS = COLS + 4;                // partial row stride
  static constexpr uint32_t W_BYTES = COLS / 64 * SLAB;
  static constexpr uint32_t STAGE = W_BYTES + NW * PANEL_ROW;
  static constexpr uint32_t PART = NW * HS * 4;
  // the ring, or the partial tile aliased over it
  __host__ __device__ static uint32_t region(int stages) {
    const uint32_t ring = stages * STAGE;
    return ring > PART ? ring : PART;
  }
  // up: 1 KB of alignment slack, the region, two mbarriers a stage, the
  // block's keep bits (4 words), every rank's (MAX_KS x 4 words) and the g
  // rows a rank keeps beyond one a warp
  static size_t up_smem(int stages, int g_rows) {
    return 1024 + region(stages) + 16 * stages + 16 + 16 * MAX_KS +
           (size_t)g_rows * COLS * 4;
  }
  // down: the slack, the region, the mbarriers and a byte a tile
  static size_t down_smem(int stages, int nt) {
    return 1024 + region(stages) + 16 * stages + (size_t)(nt + 15) / 16 * 16;
  }
};

// the producer's ring use u: wait for its stage to be free, then one
// transaction of COLS/64 W boxes at (wc + 64 p, wr) and the B box at
// (bc, br)
template <int COLS, int NW>
__device__ __forceinline__ void issue_stage(uint32_t s0, uint32_t full,
                                            uint32_t empty, int stages, int u,
                                            const CUtensorMap* w, int wc,
                                            int wr, const CUtensorMap* b,
                                            int bc, int br) {
  typedef Cfg<COLS, NW> C;
  const int st = u % stages;
  const uint32_t dst = s0 + st * C::STAGE, bar = full + 8 * st;
  if (u >= stages) mbar_wait(empty + 8 * st, (u / stages - 1) & 1);
  mbar_expect_tx(bar, C::STAGE);
  for (int p = 0; p < COLS / 64; ++p)
    tma_load_2d(dst + p * SLAB, w, wc + 64 * p, wr, bar);
  tma_load_2d(dst + C::W_BYTES, b, bc, br, bar);
}

// the consumers' ring uses base .. base + n - 1 into acc (warpgroup wg's
// slabs): each stage waited for, multiplied, and released once its
// products are done -- the last one too, so that a later loop on the same
// ring goes on at base + n
template <int COLS, int NW>
__device__ __forceinline__ void consume(
    float (&acc)[Cfg<COLS, NW>::SPW][NW / 2], uint32_t s0, uint32_t full,
    uint32_t empty, int stages, int base, int n, int wg, int lane) {
  typedef Cfg<COLS, NW> C;
#pragma unroll
  for (int j = 0; j < C::SPW; ++j)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[j][i] = 0.f;
  // keeps the zeroing out of the asynchronous region (else ptxas
  // serialises the wgmmas, C7515)
#pragma unroll
  for (int j = 0; j < C::SPW; ++j) fence_regs<NW / 2>(acc[j]);
  for (int s = 0; s < n; ++s) {
    const int u = base + s, st = u % stages;
    const uint32_t w_s = s0 + st * C::STAGE, b_s = w_s + C::W_BYTES;
    mbar_wait(full + 8 * st, (u / stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < C::SPW; ++j)
        WgmmaTA<NW>::mma(
            acc[j],
            sw128_desc(w_s + (wg * C::SPW + j) * SLAB + kk * 16 * PANEL_ROW,
                       SLAB),
            sw128_desc(b_s + kk * 32, 0));
    wgmma_commit();
    wgmma_wait<1>();  // use u - 1's products are done: release its stage
    mbar_arrive_if(empty + 8 * ((u + stages - 1) % stages),
                   s > 0 && lane == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < C::SPW; ++j) fence_regs<NW / 2>(acc[j]);
  mbar_arrive_if(empty + 8 * ((base + n + stages - 1) % stages),
                 n > 0 && lane == 0);
}

// D element 4n + 2h + e of thread t: column (wg SPW + j) 64 + 16w + g + 8h,
// row 8n + 2c + e (w = warp of the warpgroup, g = lane / 4, c = lane % 4);
// stored as part[row][column]
template <int COLS, int NW>
__device__ __forceinline__ void store_partial(
    float* part, const float (&acc)[Cfg<COLS, NW>::SPW][NW / 2], int warp,
    int lane) {
  typedef Cfg<COLS, NW> C;
  const int wg = warp / 4, w = warp % 4, g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < C::SPW; ++j) {
    const int col = (wg * C::SPW + j) * 64 + 16 * w + g;
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(8 * n + c2 + e) * C::HS + col + 8 * h] =
              acc[j][4 * n + 2 * h + e];
  }
}

// row r of the block's product summed over the ranks' partials in rank
// order; the lane's columns lane + 32 j
template <int COLS>
__device__ __forceinline__ void rank_sum(cg::cluster_group& cluster,
                                         float* part, int ks, int r, int lane,
                                         float (&sum)[COLS / 32]) {
#pragma unroll
  for (int j = 0; j < COLS / 32; ++j) sum[j] = 0.f;
  for (int q = 0; q < ks; ++q) {
    const float* src =
        cluster.map_shared_rank(part, q) + r * (COLS + 4) + lane;
#pragma unroll
    for (int j = 0; j < COLS / 32; ++j) sum[j] += src[32 * j];
  }
}

// the block's partial of x @ W's tile over the rank's K stages (ring uses
// base .. base + nst - 1) into part, then a cluster barrier: every rank's
// partial is complete
template <int T, int NW>
__device__ __forceinline__ void up_product(
    cg::cluster_group& cluster, const CUtensorMap* w, const CUtensorMap* x,
    float* part, uint32_t s0, uint32_t full, uint32_t empty, int stages,
    int base, int kb, int nst, int col0, int row0, int warp, int lane) {
  typedef Cfg<T, NW> C;
  if (warp == C::CWG * 4) {  // the producer warp: one thread issues copies
    if (lane == 0)
      for (int s = 0; s < nst; ++s) {
        const int k0 = (kb + s) * BK;
        issue_stage<T, NW>(s0, full, empty, stages, base + s, w, col0, k0, x,
                           k0, row0);
      }
    __syncwarp();
  } else {
    float acc[C::SPW][NW / 2];
    consume<T, NW>(acc, s0, full, empty, stages, base, nst, warp / 4, lane);
    named_sync(1, C::CWG * 128);  // every consumer is done with the ring
    store_partial<T, NW>(part, acc, warp, lane);
  }
  cluster.sync();
}

// two blocks an SM at widths up to 32 (the plan's per_sm): their registers
// are held to half an SM's
template <int T, int NW>
__global__ void __launch_bounds__(Cfg<T, NW>::THREADS, NW <= 32 ? 2 : 1)
    tile_skip_up_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap twg,
                        const __grid_constant__ CUtensorMap twu,
                        bf16* __restrict__ h, int* __restrict__ flags, int M,
                        int K, int N, int act, float thr, int ks,
                        int stages) {
  typedef Cfg<T, NW> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t full = s0 + C::region(stages), empty = full + 8 * stages;
  uint32_t* keep = reinterpret_cast<uint32_t*>(sm + C::region(stages) +
                                               16 * stages);  // [4]
  uint32_t* keeps = keep + 4;  // [MAX_KS][4], pushed by every rank
  float* g_s = reinterpret_cast<float*>(keeps + 4 * MAX_KS);  // [.][T]
  float* part = reinterpret_cast<float*>(sm);  // [NW][HS], after a K loop
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // = blockIdx.x % ks
  const int tile = blockIdx.x / ks, nt = N / T;
  const int col0 = tile * T, row0 = blockIdx.y * NW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this rank's K stages kb .. kb + nst - 1 and rows rb .. rb + nr - 1 of
  // the block's valid rows
  const int nk = (K + BK - 1) / BK;
  const int kb = rank * nk / ks, nst = (rank + 1) * nk / ks - kb;
  const int rv = min(NW, M - row0);
  const int rb = rank * rv / ks, nr = (rank + 1) * rv / ks - rb;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::CWG * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  if (threadIdx.x < 4) keep[threadIdx.x] = 0;
  __syncthreads();
  griddep_launch_dependents();

  // phase 1: g = act(x @ W_g) on the rank's rows, and their keep bits
  up_product<T, NW>(cluster, &twg, &tx, part, s0, full, empty, stages, 0, kb,
                    nst, col0, row0, warp, lane);
  float g_reg[T / 32];  // the warp's first row; later rows in g_s
#pragma unroll
  for (int j = 0; j < T / 32; ++j) g_reg[j] = 0.f;
  for (int lr = warp; lr < nr; lr += C::WARPS) {
    const int r = rb + lr;
    float v[T / 32];
    rank_sum<T>(cluster, part, ks, r, lane, v);
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < T / 32; ++j) {
      const float a = fmaxf(v[j], 0.f);
      v[j] = act == 0 ? a : a * a;
      mx = fmaxf(mx, v[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0 && mx > thr) atomicOr(&keep[r >> 5], 1u << (r & 31));
    if (lr < C::WARPS) {
#pragma unroll
      for (int j = 0; j < T / 32; ++j) g_reg[j] = v[j];
    } else {
#pragma unroll
      for (int j = 0; j < T / 32; ++j)
        g_s[(lr - C::WARPS) * T + lane + 32 * j] = v[j];
    }
  }
  __syncthreads();  // this block's keep bits are complete
  if (threadIdx.x < 4 * ks)  // push them to every rank of the cluster
    cluster.map_shared_rank(keeps, threadIdx.x / 4)[4 * rank +
                                                     threadIdx.x % 4] =
        keep[threadIdx.x % 4];
  fence_proxy_async();  // the partials written over the ring, before TMA
  cluster.sync();       // every rank's keep bits everywhere; partials read
  // the same in every thread of the cluster: some row of the block keeps
  // the tile
  const bool on =
      __syncthreads_or(threadIdx.x < 4 * ks && keeps[threadIdx.x] != 0) != 0;
  if (rank == 0 && threadIdx.x < (NW + 31) / 32 &&
      row0 / 32 + (int)threadIdx.x < (M + 31) / 32) {
    uint32_t any = 0;  // the 32-row group's flag
    for (int q = 0; q < ks; ++q) any |= keeps[4 * q + threadIdx.x];
    flags[(size_t)(row0 / 32 + threadIdx.x) * nt + tile] = any != 0;
  }

  if (on) {
    // phase 2: hu = x @ W_u over the same split; h = bf16(hu * g)
    up_product<T, NW>(cluster, &twu, &tx, part, s0, full, empty, stages, nst,
                      kb, nst, col0, row0, warp, lane);
    for (int lr = warp; lr < nr; lr += C::WARPS) {
      const int r = rb + lr;
      float v[T / 32];
      rank_sum<T>(cluster, part, ks, r, lane, v);
      const bool kept = (keep[r >> 5] >> (r & 31)) & 1u;
      bf16* out = h + (size_t)(row0 + r) * N + col0 + lane;
      if (lr < C::WARPS) {
#pragma unroll
        for (int j = 0; j < T / 32; ++j)
          out[32 * j] = __float2bfloat16(kept ? v[j] * g_reg[j] : 0.f);
      } else {
        const float* g = g_s + (lr - C::WARPS) * T + lane;
#pragma unroll
        for (int j = 0; j < T / 32; ++j)
          out[32 * j] = __float2bfloat16(kept ? v[j] * g[32 * j] : 0.f);
      }
    }
    cluster.sync();  // keep this block's partial alive for the others
  } else {
    // a skipped tile: W_u is never read, h is zero (no rank reads another
    // rank's shared memory after the barrier above)
    for (int e = threadIdx.x; e < nr * (T / 8); e += C::THREADS) {
      const int r = rb + e / (T / 8), c = e % (T / 8);
      *reinterpret_cast<uint4*>(h + (size_t)(row0 + r) * N + col0 + 8 * c) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

template <int DC, int NW>
__global__ void __launch_bounds__(Cfg<DC, NW>::THREADS, NW <= 32 ? 2 : 1)
    tile_skip_down_kernel(const __grid_constant__ CUtensorMap th,
                          const __grid_constant__ CUtensorMap twd,
                          const int* __restrict__ flags, float* __restrict__ y,
                          int M, int K, int N, int T, int ks, int stages) {
  typedef Cfg<DC, NW> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t full = s0 + C::region(stages), empty = full + 8 * stages;
  uint8_t* kept_s = sm + C::region(stages) + 16 * stages;  // [nt]
  float* part = reinterpret_cast<float*>(sm);  // [NW][HS], after the loop
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = blockIdx.x / ks * DC, row0 = blockIdx.y * NW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = N / T, spt = T / BK;
  const int rv = min(NW, M - row0);
  const int g0 = row0 / 32, g1 = (row0 + rv - 1) / 32;  // 32-row groups

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::CWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  griddep_wait();  // the up kernel's h and flags are complete and visible

  // the row block's kept tiles (a byte each) and their count, the same in
  // every thread
  int kept = 0;
  for (int j0 = 0; j0 < nt; j0 += C::THREADS) {
    const int j = j0 + threadIdx.x;
    int on = 0;
    if (j < nt) {
      for (int q = g0; q <= g1; ++q) on |= flags[(size_t)q * nt + j];
      kept_s[j] = on != 0;
    }
    kept += __syncthreads_count(on != 0);
  }
  // this rank's stages lo .. lo + nst - 1 of the kept tiles' stages, in
  // tile order
  const int total = kept * spt;
  const int lo = rank * total / ks, nst = (rank + 1) * total / ks - lo;

  if (warp == C::CWG * 4) {
    if (lane == 0) {
      int u = 0, s = 0;
      for (int j = 0; j < nt && s < nst; ++j) {
        if (!kept_s[j]) continue;
        for (int p = 0; p < spt && s < nst; ++p, ++u) {
          if (u < lo) continue;
          const int n0 = j * T + p * BK;
          issue_stage<DC, NW>(s0, full, empty, stages, s, &twd, c0, n0, &th,
                              n0, row0);
          ++s;
        }
      }
    }
    __syncwarp();
  } else {
    float acc[C::SPW][NW / 2];
    consume<DC, NW>(acc, s0, full, empty, stages, 0, nst, warp / 4, lane);
    named_sync(1, C::CWG * 128);
    store_partial<DC, NW>(part, acc, warp, lane);
  }
  cluster.sync();  // every rank's partial is complete

  const int rb = rank * rv / ks, nr = (rank + 1) * rv / ks - rb;
  for (int lr = warp; lr < nr; lr += C::WARPS) {
    const int r = rb + lr;
    float v[DC / 32];
    rank_sum<DC>(cluster, part, ks, r, lane, v);
    float* out = y + (size_t)(row0 + r) * K + c0 + lane;
#pragma unroll
    for (int j = 0; j < DC / 32; ++j)
      if (c0 + lane + 32 * j < K) out[32 * j] = v[j];
  }
  cluster.sync();  // keep this block's partial alive for the others
}

// a row-major (outer, inner) bf16 tensor as {inner, outer}, box {64, rows},
// 128-byte swizzle, zero fill out of bounds
int encode(CUtensorMap* map, const void* ptr, int inner, int outer, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The weights' maps, encoded once: a map is a function of its pointer,
// shape, row stride and box alone, so a hit is always the right map.
struct MapKey {
  const void* ptr;
  int inner, outer, rows;
  long long stride;
};

int weight_map(CUtensorMap* out, const void* ptr, int inner, int outer,
               int rows) {
  constexpr int SLOTS = 64;
  static std::mutex mu;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  const MapKey key = {ptr, inner, outer, rows, (long long)inner * 2};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i].ptr == key.ptr && keys[i].inner == key.inner &&
        keys[i].outer == key.outer && keys[i].rows == key.rows &&
        keys[i].stride == key.stride) {
      *out = maps[i];
      return 0;
    }
  const int e = encode(out, ptr, inner, outer, rows);
  if (e) return e;
  const int slot = used < SLOTS ? used++ : next++ % SLOTS;
  keys[slot] = key;
  maps[slot] = *out;
  return 0;
}

// cluster launch of `grid` in clusters of ks blocks (and, if dependent, as
// a programmatic dependent of the previous kernel on the stream); the
// kernel's dynamic shared memory raised to smem on first need (`raised`:
// the kernel's own record)
template <class Kernel>
int configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
              Kernel kernel, size_t* raised, dim3 grid, int threads,
              size_t smem, int ks, bool dependent,
              cudaStream_t stream) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > *raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *raised = smem;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg->attrs = attr;
  cfg->numAttrs = dependent ? 2 : 1;
  return 0;
}

int launched(cudaError_t e) {
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int T, int NW>
struct Up {
  typedef Cfg<T, NW> C;
  static size_t raised;
  static int config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    dim3 grid, int ks, int stages, int g_rows,
                    cudaStream_t s) {
    return configure(cfg, attr, tile_skip_up_kernel<T, NW>, &raised, grid,
                     C::THREADS, C::up_smem(stages, g_rows), ks, false, s);
  }
  static int launch(const CUtensorMap& tx, const CUtensorMap& twg,
                    const CUtensorMap& twu, void* h, void* flags, int M,
                    int K, int N, int act, float thr, int ks, int stages,
                    int g_rows, cudaStream_t s) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    const int e = config(&cfg, attr, dim3(N / T * ks, (M + NW - 1) / NW, 1),
                         ks, stages, g_rows, s);
    if (e) return e;
    return launched(cudaLaunchKernelEx(&cfg, tile_skip_up_kernel<T, NW>, tx,
                                       twg, twu, (bf16*)h, (int*)flags, M, K,
                                       N, act, thr, ks, stages));
  }
  // the clusters of ks blocks the card holds at once, and a block's
  // shared memory
  static int resident(int ks, int stages, int g_rows, int* clusters,
                      int* smem) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    const int e = config(&cfg, attr, dim3(ks * 64, 1, 1), ks, stages, g_rows,
                         0);
    if (e) return e;
    *smem = (int)C::up_smem(stages, g_rows);
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, tile_skip_up_kernel<T, NW>, &cfg);
  }
};
template <int T, int NW>
size_t Up<T, NW>::raised = 0;

template <int DC, int NW>
struct Down {
  typedef Cfg<DC, NW> C;
  static size_t raised;
  static int config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    dim3 grid, int ks, int stages, int nt, bool dependent,
                    cudaStream_t s) {
    return configure(cfg, attr, tile_skip_down_kernel<DC, NW>, &raised, grid,
                     C::THREADS, C::down_smem(stages, nt), ks, dependent, s);
  }
  static int launch(const CUtensorMap& th, const CUtensorMap& twd,
                    const void* flags, void* y, int M, int K, int N, int T,
                    int ks, int stages, cudaStream_t s) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    const int e =
        config(&cfg, attr, dim3((K + DC - 1) / DC * ks, (M + NW - 1) / NW, 1),
               ks, stages, N / T, true, s);
    if (e) return e;
    return launched(cudaLaunchKernelEx(&cfg, tile_skip_down_kernel<DC, NW>,
                                       th, twd, (const int*)flags, (float*)y,
                                       M, K, N, T, ks, stages));
  }
  static int resident(int ks, int stages, int nt, int* clusters,
                      int* smem) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    // the occupancy query takes the cluster dimension alone
    const int e = config(&cfg, attr, dim3(ks * 64, 1, 1), ks, stages, nt,
                         false, 0);
    if (e) return e;
    *smem = (int)C::down_smem(stages, nt);
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, tile_skip_down_kernel<DC, NW>, &cfg);
  }
};
template <int DC, int NW>
size_t Down<DC, NW>::raised = 0;

// the up kernel's form for (T, width), or the down kernel's for (DC, width)
#define TS_WIDTHS(F, COLS) \
  F(COLS, 8) F(COLS, 16) F(COLS, 32) F(COLS, 64) F(COLS, 128)

}  // namespace

// x (M, K), wg/wu (K, N), wd (N, K) bf16, row-major contiguous and 16-byte
// aligned. Outputs: y (M, K) float32, h (M, N) bf16, flags (ceil(M/32), N/T)
// int32. Requires K % 8 == 0, T in {64, 128, 256}, N % T == 0, thr >= 0.
// act: 0 = relu, 1 = relu^2. The plan (kernels/sparse_ffn.py
// tile_skip_plan): width (rows a block: 8, 16, 32, 64 or 128), the up
// kernel's ks, ring depth and g rows kept in shared memory, the down
// kernel's columns a block (64 or 128), ks and ring depth. The down kernel
// is launched as a programmatic dependent of the up kernel.
extern "C" int tile_skip_ffn_bf16(const void* x, const void* wg,
                                  const void* wu, const void* wd, void* y,
                                  void* h, void* flags, int M, int K, int N,
                                  int T, int act, float thr, int width,
                                  int ks, int stages, int g_rows, int dc,
                                  int ks_down, int stages_down,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ks < 1 || ks > MAX_KS || ks_down < 1 || ks_down > MAX_KS ||
      stages < 3 || stages_down < 3 || g_rows < 0 || M < 1 || K < 1 ||
      K % 8 || (T != 64 && T != 128 && T != 256) || N % T ||
      (dc != 64 && dc != 128) || !(thr >= 0.f))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, th, twg, twu, twd;
  int e = encode(&tx, x, K, M, width);
  if (!e) e = encode(&th, h, N, M, width);
  if (!e) e = weight_map(&twg, wg, N, K, BK);
  if (!e) e = weight_map(&twu, wu, N, K, BK);
  if (!e) e = weight_map(&twd, wd, K, N, BK);
  if (e) return e;
  e = (int)cudaErrorInvalidValue;
#define TS_UP(TT, NW)                                                       \
  if (T == TT && width == NW)                                               \
    e = Up<TT, NW>::launch(tx, twg, twu, h, flags, M, K, N, act, thr, ks,   \
                           stages, g_rows, s);
  TS_WIDTHS(TS_UP, 64) TS_WIDTHS(TS_UP, 128) TS_WIDTHS(TS_UP, 256)
#undef TS_UP
  if (e) return e;
  e = (int)cudaErrorInvalidValue;
#define TS_DOWN(DD, NW)                                                     \
  if (dc == DD && width == NW)                                              \
    e = Down<DD, NW>::launch(th, twd, flags, y, M, K, N, T, ks_down,        \
                             stages_down, s);
  TS_WIDTHS(TS_DOWN, 64) TS_WIDTHS(TS_DOWN, 128)
#undef TS_DOWN
  return e;
}

// *clusters = how many clusters of ks blocks of the up kernel's (down = 0:
// T = cols, extra = g rows) or the down kernel's (down = 1: DC = cols,
// extra = N / T) launch at (width, stages) fit on the card at once
// (cudaOccupancyMaxActiveClusters), and *smem = a block's dynamic shared
// memory. For measuring launch plans; the kernel path does not call it.
extern "C" int tile_skip_resident_clusters(int down, int cols, int width,
                                           int ks, int stages, int extra,
                                           int* clusters, int* smem) {
  if (ks < 1 || ks > MAX_KS || stages < 3 || extra < 0)
    return (int)cudaErrorInvalidValue;
#define TS_UP(TT, NW)                  \
  if (!down && cols == TT && width == NW) \
    return Up<TT, NW>::resident(ks, stages, extra, clusters, smem);
  TS_WIDTHS(TS_UP, 64) TS_WIDTHS(TS_UP, 128) TS_WIDTHS(TS_UP, 256)
#undef TS_UP
#define TS_DOWN(DD, NW)                \
  if (down && cols == DD && width == NW) \
    return Down<DD, NW>::resident(ks, stages, extra, clusters, smem);
  TS_WIDTHS(TS_DOWN, 64) TS_WIDTHS(TS_DOWN, 128)
#undef TS_DOWN
  return (int)cudaErrorInvalidValue;
}
