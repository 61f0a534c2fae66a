// K1: fused gate matmul + activation + TwELL pack epilogue (paper Alg. 1).
//
// Replaces src/repro/kernels/twell_pack.py:61 twell_gate_matmul_pallas
// (its _kernel): h = act(x @ W_g) in f32, packed per T-column tile into
// tile-locally compacted values, global column indices and the exact
// per-tile non-zero count.
//
// What bounds it on the H100: at decode (M <= 8) the whole of W_g is read
// once for a few rows -- 23.1 MB per paper-0.5b layer (K 2048, N 5632),
// 6.9 us at 3.35 TB/s; 33.6 MB, 10.0 us at olmo-1b's N 8192; the product
// itself is negligible. At a 256-row prefill step the 2*M*K*N = 5.9 GFLOP
// take 6.0 us at the bf16 tensor-core peak (989 TFLOP/s), next to the 7.5
// us of bytes: only wgmma reaches that rate, and W_g must not be streamed
// once per small row block.
//
// Design (the primitives are sm90_common.cuh, shared with K4 and K7):
//   * swap-AB, one code path for every M: a block computes D^T = W_tile^T
//     x^T, the tile's T columns as wgmma's M (T/64 slabs of m64, split over
//     the consumer warpgroups: one at T 64, two above) and the block's rows
//     of x as wgmma's N, M rounded up to one of n 8, 16, 32, 64, 128. A =
//     the W box read MN-major from shared memory (the transpose bit: W is
//     stored as TMA writes it, never transposed), B = the x box, K-major.
//     A decode block (M = 4) runs n 8, not 32 rows of zeros;
//   * copies: one producer warp issues TMA into a ring of `stages` stages
//     with full and empty mbarriers; a stage is 64 k deep (one 128-byte
//     swizzle row of x): the W box {64 columns, 64 k} T/64 times and the x
//     box {64 k, n rows}. 2-D tensor maps over x (M, K) and W (K, N), 128B
//     swizzle, zero fill out of bounds: ragged M and K need no padding;
//   * the K loop is split over a cluster of `ks` blocks in whole 64-k
//     stages (a rank with none contributes zeros). Each block stores its
//     f32 partial transposed, [row][column], over the ring it no longer
//     needs; after a cluster barrier rank r sums its share of the rows over
//     all ranks through distributed shared memory, in rank order (the same
//     bits every run, no atomics), applies the activation and packs those
//     rows -- the dense h_g never reaches device memory;
//   * the pack compacts in stable column order with a warp ballot and a
//     popcount prefix, equal to the reference's stable sort; the count
//     written is exact even when a tile overflows its T/C slots (the
//     caller clips it).
// n, ks and the ring depth come from the host plan (kernels/twell_pack.py
// gate_plan: one wave over the SMs), and twell_gate_matmul_bf16 launches
// only the (T, n) pairs built here. Every branch around a wgmma is on
// values uniform over the block (stage counters), so ptxas keeps them
// asynchronous.
#include <cooperative_groups.h>

#include "sm90_common.cuh"

namespace cg = cooperative_groups;
using namespace sm90;

namespace {

constexpr int BK = 64;                            // k of a stage
constexpr uint32_t SLAB = BK * PANEL_ROW;         // one W box: 64 k x 64 cols
constexpr int MAX_KS = 8;                         // portable cluster size
constexpr size_t SMEM_MAX = 232448;               // a block's shared memory

template <int T, int NW>
struct Cfg {
  static constexpr int CWG = T == 64 ? 1 : 2;     // consumer warpgroups
  static constexpr int SPW = T / 64 / CWG;        // slabs per warpgroup
  static constexpr int THREADS = CWG * 128 + 32;  // + the producer warp
  static constexpr int HS = T + 4;                // partial row stride (f32)
  static constexpr uint32_t W_BYTES = T / 64 * SLAB;
  static constexpr uint32_t STAGE = W_BYTES + NW * PANEL_ROW;
  static constexpr uint32_t PART = NW * HS * 4;
  // the ring, or the partial tile aliased over it; the barriers after it
  __host__ __device__ static uint32_t region(int stages) {
    const uint32_t ring = stages * STAGE;
    return ring > PART ? ring : PART;
  }
  static size_t smem(int stages) { return 1024 + region(stages) + 16 * stages; }
};

// two blocks an SM at widths up to 32 (the plan's blocks_per_sm): their
// registers are held to half an SM's
template <int T, int NW>
__global__ void __launch_bounds__(Cfg<T, NW>::THREADS, NW <= 32 ? 2 : 1)
    gate_pack_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     bf16* __restrict__ vals, int* __restrict__ idx,
                     int* __restrict__ nnz, int M, int K, int N, int tc,
                     int act, int ks, int stages) {
  typedef Cfg<T, NW> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t full = s0 + C::region(stages), empty = full + 8 * stages;
  float* part = reinterpret_cast<float*>(sm);  // [NW][HS], after the K loop
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // = blockIdx.x % ks
  const int tile = blockIdx.x / ks;
  const int col0 = tile * T, row0 = blockIdx.y * NW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this rank's stages kb .. kb + nst - 1 of the K loop
  const int nk = (K + BK - 1) / BK;
  const int kb = rank * nk / ks, nst = (rank + 1) * nk / ks - kb;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::CWG * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::CWG * 4) {  // the producer warp: one thread issues copies
    if (lane == 0) {
      for (int s = 0; s < nst; ++s) {
        const int st = s % stages, k0 = (kb + s) * BK;
        const uint32_t dst = s0 + st * C::STAGE, bar = full + 8 * st;
        if (s >= stages) mbar_wait(empty + 8 * st, (s / stages - 1) & 1);
        mbar_expect_tx(bar, C::STAGE);
        for (int p = 0; p < T / 64; ++p)
          tma_load_2d(dst + p * SLAB, &tw, col0 + 64 * p, k0, bar);
        tma_load_2d(dst + C::W_BYTES, &tx, k0, row0, bar);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg owns slabs wg * SPW .. + SPW - 1 of the tile
    const int wg = warp / 4;
    float acc[C::SPW][NW / 2];
#pragma unroll
    for (int j = 0; j < C::SPW; ++j)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[j][i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int st = s % stages;
      const uint32_t w_s = s0 + st * C::STAGE, x_s = w_s + C::W_BYTES;
      mbar_wait(full + 8 * st, (s / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < C::SPW; ++j)
          WgmmaTA<NW>::mma(
              acc[j],
              sw128_desc(w_s + (wg * C::SPW + j) * SLAB + kk * 16 * PANEL_ROW,
                         SLAB),
              sw128_desc(x_s + kk * 32, 0));
      wgmma_commit();
      wgmma_wait<1>();  // stage s - 1's products are done: release it
      mbar_arrive_if(empty + 8 * ((s + stages - 1) % stages),
                     s > 0 && lane == 0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::SPW; ++j) fence_regs<NW / 2>(acc[j]);
    named_sync(1, C::CWG * 128);  // every consumer is done with the ring
    // D element 4n + 2h + e of thread t: tile column 16w + g + 8h of the
    // slab, row 8n + 2c + e (w = warp of the warpgroup, g = lane / 4,
    // c = lane % 4); stored as part[row][column]
    const int w = warp % 4, g = lane / 4, c2 = (lane % 4) * 2;
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
  cluster.sync();  // every rank's partial tile is complete

  // rows rb .. re - 1 of the block's valid rows: summed over the ranks in
  // rank order, activated and packed, a warp a row
  const int rv = min(NW, M - row0);
  const int rb = rank * rv / ks, re = (rank + 1) * rv / ks;
  const int nt = N / T;
  const size_t slots = (size_t)nt * tc;  // packed row length
  for (int r = rb + warp; r < re; r += C::THREADS / 32) {
    float sum[T / 32];
#pragma unroll
    for (int j = 0; j < T / 32; ++j) sum[j] = 0.f;
    for (int q = 0; q < ks; ++q) {
      const float* src = cluster.map_shared_rank(part, q) + r * C::HS + lane;
#pragma unroll
      for (int j = 0; j < T / 32; ++j) sum[j] += src[32 * j];
    }
    const int m = row0 + r;
    const size_t out = (size_t)m * slots + (size_t)tile * tc;
    int count = 0;
#pragma unroll
    for (int j = 0; j < T / 32; ++j) {
      const float relu = fmaxf(sum[j], 0.f);
      const float h = act == 0 ? relu : relu * relu;
      const bool on = h > 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      const int pos = count + __popc(bits & ((1u << lane) - 1u));
      if (on && pos < tc) {
        vals[out + pos] = __float2bfloat16(h);
        idx[out + pos] = col0 + 32 * j + lane;
      }
      count += __popc(bits);
    }
    for (int s = min(count, tc) + lane; s < tc; s += 32) {
      vals[out + s] = __float2bfloat16(0.f);
      idx[out + s] = 0;
    }
    if (lane == 0) nnz[(size_t)m * nt + tile] = count;  // exact, unclipped
  }
  cluster.sync();  // keep this block's partial tile alive for the others
}

// a row-major (outer, inner) bf16 tensor as {inner, outer}, box {64, rows},
// 128-byte swizzle, zero fill out of bounds
int make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
             int rows) {
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

// the launch configuration of gate_pack_kernel<T, NW> over `grid` in
// clusters of ks blocks (attr: its one attribute), with the kernel's
// dynamic shared memory raised to what the ring needs
template <int T, int NW>
int configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid,
              int ks, int stages, cudaStream_t stream) {
  const size_t smem = Cfg<T, NW>::smem(stages);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gate_pack_kernel<T, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(Cfg<T, NW>::THREADS, 1, 1);
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

template <int T, int NW>
int launch(const void* x, const void* w, void* vals, void* idx, void* nnz,
           int M, int K, int N, int tc, int act, int ks, int stages,
           cudaStream_t stream) {
  CUtensorMap tx, tw;
  int e = make_map(&tx, x, K, M, NW);
  if (!e) e = make_map(&tw, w, N, K, BK);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!e)
    e = configure<T, NW>(&cfg, &attr, dim3(N / T * ks, (M + NW - 1) / NW, 1),
                         ks, stages, stream);
  if (e) return e;
  cudaError_t ce = cudaLaunchKernelEx(&cfg, gate_pack_kernel<T, NW>, tx, tw,
                                      (bf16*)vals, (int*)idx, (int*)nnz, M, K,
                                      N, tc, act, ks, stages);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// the clusters of ks blocks that can be resident on the card at once
template <int T, int NW>
int resident(int ks, int stages, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<T, NW>(&cfg, &attr, dim3(ks * 64, 1, 1), ks,
                                 stages, 0);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveClusters(out, gate_pack_kernel<T, NW>,
                                             &cfg);
}

template <int T>
int launch_width(const void* x, const void* w, void* vals, void* idx,
                 void* nnz, int M, int K, int N, int tc, int act, int width,
                 int ks, int stages, cudaStream_t s) {
#define GATE_WIDTH(NW)                                                     \
  case NW:                                                                 \
    return launch<T, NW>(x, w, vals, idx, nnz, M, K, N, tc, act, ks, stages, \
                         s);
  switch (width) {
    GATE_WIDTH(8)
    GATE_WIDTH(16)
    GATE_WIDTH(32)
    GATE_WIDTH(64)
    GATE_WIDTH(128)
  }
#undef GATE_WIDTH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) bf16, w (K, N) bf16, row-major contiguous and 16-byte aligned.
// Outputs: vals (M, N/C) bf16, idx (M, N/C) int32, nnz (M, N/T) int32.
// Requires K % 8 == 0, T in {64, 128, 256}, N % T == 0, T % C == 0.
// act: 0 = relu, 1 = relu^2. width (rows of x a block: 8, 16, 32, 64 or
// 128), ks (blocks a cluster, 1..8) and stages (ring depth, >= 3) are the
// host plan's (twell_pack.gate_plan).
extern "C" int twell_gate_matmul_bf16(const void* x, const void* w,
                                      void* vals, void* idx, void* nnz,
                                      int M, int K, int N, int T, int C,
                                      int act, int width, int ks, int stages,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ks < 1 || ks > MAX_KS || stages < 3 || M < 1 || K < 1 || C < 1 ||
      T % C || N % T || K % 8)
    return (int)cudaErrorInvalidValue;
  const int tc = T / C;
  switch (T) {
    case 64:
      return launch_width<64>(x, w, vals, idx, nnz, M, K, N, tc, act, width,
                              ks, stages, s);
    case 128:
      return launch_width<128>(x, w, vals, idx, nnz, M, K, N, tc, act, width,
                               ks, stages, s);
    case 256:
      return launch_width<256>(x, w, vals, idx, nnz, M, K, N, tc, act, width,
                               ks, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

// *clusters = how many clusters of the launch (T, width, ks, stages) fit on
// the card at once (cudaOccupancyMaxActiveClusters): tiles x row blocks
// clusters run in one wave when it is at least that many. For measuring
// launch plans; the kernel path does not call it.
extern "C" int twell_gate_resident_clusters(int T, int width, int ks,
                                            int stages, int* clusters) {
  if (ks < 1 || ks > MAX_KS || stages < 3) return (int)cudaErrorInvalidValue;
#define GATE_RESIDENT(TT, NW) \
  if (T == TT && width == NW) return resident<TT, NW>(ks, stages, clusters);
  GATE_RESIDENT(256, 8)
  GATE_RESIDENT(256, 16)
  GATE_RESIDENT(256, 32)
  GATE_RESIDENT(256, 64)
  GATE_RESIDENT(256, 128)
#undef GATE_RESIDENT
  return (int)cudaErrorInvalidValue;
}
