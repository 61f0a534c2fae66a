// K1: fused gate matmul + activation + TwELL pack epilogue (paper Alg. 1).
//
// Replaces src/repro/kernels/twell_pack.py:61 twell_gate_matmul_pallas
// (its _kernel): h = act(x @ W_g) in f32, packed per 256-column tile into
// tile-locally compacted values, global column indices and the exact
// per-tile non-zero count.
//
// What bounds it on the H100: at decode (M <= 8) the whole of W_g is read
// once for a few rows -- 23.1 MB per paper-0.5b layer, 6.9 us at 3.35 TB/s;
// the product itself is negligible. At a 256-row prefill chunk the
// 2*M*K*N = 5.9 GFLOP product matters as much (6 us at 989 TFLOP/s bf16).
//
// Design:
//   * the pack needs a whole T-column tile of f32 activations, but one block
//     per (32-row block, tile) gives only N/T = 22 blocks at decode, each
//     running the full K loop: far too few to pull the memory rate. So the
//     K loop of every (row block, tile) is split over a cluster of KSPLIT = 8
//     blocks (Hopper thread-block clusters), each streaming 1/8 of the tile's
//     W_g rows through a three-stage cp.async pipeline into WMMA bf16
//     16x16x16 products with f32 accumulation;
//   * the eight partial tiles stay in shared memory; after a cluster barrier
//     block r sums rows 4r .. 4r+3 of all eight through distributed shared
//     memory, in rank order (the same sum every run), applies the
//     activation and packs those rows -- the dense h_g never reaches device
//     memory;
//   * the pack compacts in stable column order with a warp ballot and a
//     popcount prefix (no atomics), equal to the reference's stable sort;
//     the count written is exact even when a tile overflows its T/C slots
//     (the caller clips it);
//   * rows past M and K past its end are zero-filled by the copy and never
//     written: ragged M and K need no padding by the caller.
// Later work: wgmma/TMA, and skipping the MMA work of the 28 padded rows of
// a decode-sized block.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BK = 32;        // K depth per stage
constexpr int NSTAGE = 3;     // cp.async pipeline depth
constexpr int KSPLIT = 8;     // blocks per cluster, splitting the K loop
constexpr int RPB = BM / KSPLIT;  // rows each block of a cluster packs
constexpr int TMAX = 256;     // widest tile
constexpr int XS = BK + 8;    // x stage row stride (elements)
constexpr int WS = TMAX + 8;  // W stage row stride (elements)
constexpr int HS = TMAX + 4;  // f32 tile row stride
constexpr int NTHREADS = 256;

// raw 16-bit storage, read by WMMA as bf16
struct Stage {
  uint16_t x[BM * XS];
  uint16_t w[BK * WS];
};

// dynamic shared memory: the stages, with this block's partial f32 tile
// aliased over them once the K loop is done, then the reduced rows this
// block packs
constexpr size_t STAGE_BYTES = NSTAGE * sizeof(Stage);
constexpr size_t TILE_BYTES = sizeof(float) * BM * HS;
constexpr size_t PART_BYTES = STAGE_BYTES > TILE_BYTES ? STAGE_BYTES
                                                       : TILE_BYTES;
constexpr size_t SMEM_BYTES = PART_BYTES + sizeof(float) * RPB * HS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes = zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage K rows k0 .. k0+BK-1 (those below k_end) of x and of the tile's W
__device__ __forceinline__ void load_stage(Stage& st, const bf16* x,
                                           const bf16* w, int M, int K, int N,
                                           int T, int row0, int col0, int k0,
                                           int k_end) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * BK / 8; i += NTHREADS) {  // x: BM x BK
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = row0 + r < M && k0 + c < k_end;
    const bf16* src = ok ? x + (size_t)(row0 + r) * K + k0 + c : x;
    cp_async16(&st.x[r * XS + c], src, ok);
  }
  const int per_row = T / 8;  // W: BK x T
  for (int i = tid; i < BK * per_row; i += NTHREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = k0 + r < k_end;
    const bf16* src = ok ? w + (size_t)(k0 + r) * N + col0 + c : w;
    cp_async16(&st.w[r * WS + c], src, ok);
  }
}

__global__ void __cluster_dims__(1, 1, KSPLIT) __launch_bounds__(NTHREADS)
    gate_pack_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ vals, int* __restrict__ idx,
                     int* __restrict__ nnz, int M, int K, int N, int T,
                     int tc, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Stage* st_all = reinterpret_cast<Stage*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw);               // [BM][HS]
  float* rows = reinterpret_cast<float*>(smem_raw + PART_BYTES);  // [RPB][HS]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // = blockIdx.z: K-split part
  const int row0 = blockIdx.x * BM;
  const int tile = blockIdx.y;
  const int col0 = tile * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rf = warp & 1;     // 16-row fragment of the block
  const int cgrp = warp >> 1;  // column group: fragments cgrp, cgrp+4, ...
  const int nf = T / 64;       // column fragments per warp (1..4)

  // this block's share of the K loop, in whole stages
  const int kchunk = ((K + KSPLIT - 1) / KSPLIT + BK - 1) / BK * BK;
  const int k_beg = min(rank * kchunk, K);
  const int k_end = min(k_beg + kchunk, K);
  const int nk = (k_end - k_beg + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk)
      load_stage(st_all[s], x, w, M, K, N, T, row0, col0, k_beg + s * BK,
                 k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();  // stage kt has landed
    __syncthreads();              // ... and stage kt - 1 is consumed
    const int nxt = kt + NSTAGE - 1;
    if (nxt < nk)
      load_stage(st_all[nxt % NSTAGE], x, w, M, K, N, T, row0, col0,
                 k_beg + nxt * BK, k_end);
    cp_async_commit();
    const Stage& st = st_all[kt % NSTAGE];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(
          a, reinterpret_cast<const bf16*>(&st.x[(rf * 16) * XS + kk]), XS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(
              b,
              reinterpret_cast<const bf16*>(
                  &st.w[kk * WS + (cgrp + 4 * i) * 16]),
              WS);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages the tile aliases
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < nf)
      wmma::store_matrix_sync(&part[(rf * 16) * HS + (cgrp + 4 * i) * 16],
                              acc[i], HS, wmma::mem_row_major);
  cluster.sync();  // all eight partial tiles are complete

  // reduce rows rank*RPB .. +RPB-1 over the cluster, in rank order
  const int r0 = rank * RPB;
  for (int e = threadIdx.x; e < RPB * T; e += NTHREADS) {
    const int r = e / T, c = e % T;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KSPLIT; ++q)
      s += cluster.map_shared_rank(part, q)[(r0 + r) * HS + c];
    rows[r * HS + c] = s;
  }
  __syncthreads();

  const int nt = N / T;
  const int slots = nt * tc;  // packed row length
  if (warp < RPB) {
    const int m = row0 + r0 + warp;
    if (m < M) {
      const size_t out = (size_t)m * slots + (size_t)tile * tc;
      int count = 0;
      for (int c0 = 0; c0 < T; c0 += 32) {
        const float relu = fmaxf(rows[warp * HS + c0 + lane], 0.f);
        const float h = act == 0 ? relu : relu * relu;
        const bool on = h > 0.f;
        const unsigned bits = __ballot_sync(0xffffffffu, on);
        const int pos = count + __popc(bits & ((1u << lane) - 1u));
        if (on && pos < tc) {
          vals[out + pos] = __float2bfloat16(h);
          idx[out + pos] = col0 + c0 + lane;
        }
        count += __popc(bits);
      }
      for (int s = min(count, tc) + lane; s < tc; s += 32) {
        vals[out + s] = __float2bfloat16(0.f);
        idx[out + s] = 0;
      }
      if (lane == 0) nnz[(size_t)m * nt + tile] = count;  // exact, unclipped
    }
  }
  cluster.sync();  // keep this block's partial tile alive for the others
}

}  // namespace

// x (M, K) bf16, w (K, N) bf16, all row-major contiguous. Outputs:
// vals (M, N/C) bf16, idx (M, N/C) int32, nnz (M, N/T) int32.
// Requires K % 8 == 0, T % 64 == 0, T <= 256, N % T == 0, T % C == 0.
// act: 0 = relu, 1 = relu^2.
extern "C" int twell_gate_matmul_bf16(const void* x, const void* w,
                                      void* vals, void* idx, void* nnz,
                                      int M, int K, int N, int T, int C,
                                      int act, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gate_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + BM - 1) / BM, N / T, KSPLIT);
  gate_pack_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)vals, (int*)idx, (int*)nnz, M,
      K, N, T, T / C, act);
  return (int)cudaGetLastError();
}
