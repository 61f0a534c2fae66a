// K6: the non-gated TwELL down projection (paper App. C.2, Listing 3).
//
// Replaces src/repro/kernels/sparse_ffn.py:105 twell_down_proj_pallas (its
// _down_kernel at :80):   y = unpack(h) @ W_d,  f32 out, where the up
// projection itself produced the TwELL pattern (h = act(x @ W_u), kernel
// K1). As a sum over the row's valid slots:
//   y[m, :] = sum_t sum_{s < nnz[m, t]} float(vals[m, t*tc + s])
//                                       * float(W_d[idx[m, t*tc + s], :])
//
// What bounds it on the H100: bytes. Only the W_d rows the pattern names
// are read (at olmo-1b's shape, ~80 valid slots of 1024 a row, 4 KB each),
// plus the packed values, indices and counts and the f32 output; the flops
// (2 K per valid slot) are small beside that.
//
// Design:
//   * the Pallas body scatters each (row block, tile) into a dense (bm, T)
//     block through a one-hot compare and runs it on the MXU; on Hopper
//     that is dense work over zeros, so a block walks the row's valid slots
//     instead (as K2, K8 and K9 do);
//   * grid (row, 256-column slice of y), so a decode step of 4 rows still
//     spreads over 32 blocks; each block turns the row's tile counts into
//     offsets (a prefix sum, warp 0) and compacts the valid slots' values
//     and indices into shared memory in slot order;
//   * each of the block's 8 warps takes one contiguous eighth of the
//     compacted slots; each lane owns 8 consecutive columns of the slice,
//     reads a W_d row with one 16-byte load per slot and accumulates in 8
//     f32 registers (bf16 x bf16 products in f32, f32 sums, nothing
//     rounded to bf16);
//   * the 8 warps' partial sums meet in shared memory and are added in
//     warp order: no float atomics, the same bits from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SLICE = 32 * 8;  // y columns per block: 8 per lane

__global__ void __launch_bounds__(NTHREADS)
    down_proj_kernel(const bf16* __restrict__ vals,
                     const int* __restrict__ idx, const int* __restrict__ nnz,
                     const bf16* __restrict__ wd, float* __restrict__ y,
                     int K, int nt, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = nt * tc;
  int* s_col = reinterpret_cast<int*>(smem_raw);           // [slots]
  float* s_v = reinterpret_cast<float*>(s_col + slots);    // [slots]
  int* s_off = reinterpret_cast<int*>(s_v + slots);        // [nt + 1]
  __shared__ __align__(16) float s_part[NWARPS][SLICE];

  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* nrow = nnz + (size_t)m * nt;

  // 1. offsets of each tile's valid slots: an exclusive prefix over
  //    min(nnz, tc), 32 tiles at a time by warp 0
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < nt ? min(max(nrow[t], 0), tc) : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      if (t < nt) s_off[t] = carry + inc - c;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) s_off[nt] = carry;
  }
  __syncthreads();
  const int count = s_off[nt];

  // 2. compact the valid slots in slot order: slot s of tile t lands at
  //    s_off[t] + s
  for (int i = threadIdx.x; i < slots; i += NTHREADS) {
    const int t = i / tc, s = i - t * tc;
    if (s < s_off[t + 1] - s_off[t]) {
      s_col[s_off[t] + s] = idx[(size_t)m * slots + i];
      s_v[s_off[t] + s] = __bfloat162float(vals[(size_t)m * slots + i]);
    }
  }
  __syncthreads();

  // 3. warp w sums its contiguous share of the slots for 8 columns a lane
  const int k0 = blockIdx.y * SLICE + lane * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (k0 < K) {
    const int share = (count + NWARPS - 1) / NWARPS;
    const int p0 = warp * share, p1 = min(count, p0 + share);
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(wd + (size_t)s_col[p] * K + k0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float v = s_v[p];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 w = __bfloat1622float2(h[j]);
        acc[2 * j] = fmaf(v, w.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(v, w.y, acc[2 * j + 1]);
      }
    }
  }
  float4* part = reinterpret_cast<float4*>(&s_part[warp][lane * 8]);
  part[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  part[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();

  // 4. the warps' partial sums in warp order, one column a thread
  const int c = threadIdx.x;  // NTHREADS == SLICE
  const int k = blockIdx.y * SLICE + c;
  if (k < K) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += s_part[w][c];
    y[(size_t)m * K + k] = sum;
  }
}

static_assert(NTHREADS == SLICE, "one thread per column in the final sum");

}  // namespace

// vals (M, nt*tc) bf16, idx (M, nt*tc) int32, nnz (M, nt) int32 (counts
// past tc are read as tc), wd (N, K) bf16 -> y (M, K) float32.
// Requires K % 8 == 0 and 16-byte aligned wd.
extern "C" int twell_down_proj_bf16(const void* vals, const void* idx,
                                    const void* nnz, const void* wd, void* y,
                                    int M, int K, int nt, int tc,
                                    void* stream) {
  const size_t slots = (size_t)nt * tc;
  const size_t smem = slots * (sizeof(int) + sizeof(float)) +
                      (size_t)(nt + 1) * sizeof(int);
  if (smem > 48 * 1024 - sizeof(float) * NWARPS * SLICE) {
    cudaError_t e = cudaFuncSetAttribute(
        down_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(M, (K + SLICE - 1) / SLICE);
  down_proj_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)vals, (const int*)idx, (const int*)nnz, (const bf16*)wd,
      (float*)y, K, nt, tc);
  return (int)cudaGetLastError();
}
