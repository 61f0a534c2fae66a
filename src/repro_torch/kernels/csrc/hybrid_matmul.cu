// K8 and K9: the ELL side of the hybrid training format's two products
// (paper Sec. 3.5, Algorithm 3 and Listing 5).
//
// K8 replaces src/repro/kernels/hybrid_matmul.py:48 hybrid_to_dense_pallas
// (its _h2d_kernel):   y[m, :] = sum_e vals[m, e] * W[idx[m, e], :]
// over the valid slots (e < row_nnz[m] of a row not in the dense backup);
// a backup row gives 0 here (the caller adds its dense product).
// K9 replaces src/repro/kernels/hybrid_matmul.py:101 dense_to_hybrid_pallas
// (its _d2h_kernel):   vals[m, e] = x[m, :] . Wt[idx[m, e], :]
// on the valid slots, 0 elsewhere -- the SDDMM that computes only the
// pattern's entries of x @ W, with W passed transposed (Wt is (N, K)).
//
// What bounds them on the H100: bytes. At the training shape (M = 8192
// tokens, ELL width 128, ~100 valid slots a row, K = 2048) K8 writes an
// f32 (M, K) output and K9 reads an (M, K) input; each reads a W row of
// 4 KB per valid slot, and the few hundred distinct rows a batch touches
// stay in the 50 MB L2, so device memory sees each once.
//
// Design (the paper's CUDA-core branch of Algorithm 3, K2's gather loop):
//   * the TPU kernels scatter each ELL entry into a one-hot (row block x
//     N tile) and run the tile on the MXU; here a row's valid slots are a
//     prefix of its ELL row (pack compacts them in order), so a block
//     loops over that prefix directly and never visits an empty slot;
//   * K8: grid (row, 1024-column slice of y); the block stages the row's
//     slot values and indices in shared memory, then each thread keeps 8
//     f32 accumulators of y in registers and walks the slots in order with
//     one 16-byte load of W's row per slot (neighbouring threads read
//     neighbouring columns: coalesced, W read by contiguous rows);
//   * K9: grid (row); the block stages x's row in shared memory, each warp
//     takes every fourth slot and forms the dot product with Wt's row by
//     16-byte loads and a shuffle reduction;
//   * every sum is taken in one fixed order inside one block: no float
//     atomics, each result the same from run to run.
// Types: W and x in bfloat16 or float32 (accumulation in f32); K8's slot
// values in f32 (the wrapper widens bf16 values; bf16 -> f32 is exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int H2D_THREADS = 128;
constexpr int H2D_COLS = 8 * H2D_THREADS;  // y columns per block
constexpr int D2H_WARPS = 4;
constexpr int MAX_E = 1024;                // ELL width the kernels take

// 8 consecutive elements starting at p (8-element aligned) as floats
__device__ __forceinline__ void load8(const bf16* __restrict__ p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ int valid_slots(const int* __restrict__ row_nnz,
                                           const uint8_t* __restrict__ sparse,
                                           int m, int E) {
  return sparse[m] ? min(max(row_nnz[m], 0), E) : 0;
}

template <typename TW>
__global__ void __launch_bounds__(H2D_THREADS)
    h2d_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
               const int* __restrict__ row_nnz,
               const uint8_t* __restrict__ sparse, const TW* __restrict__ w,
               float* __restrict__ y, int E, int K) {
  __shared__ float s_v[MAX_E];
  __shared__ int s_i[MAX_E];
  const int m = blockIdx.x;
  const int k0 = blockIdx.y * H2D_COLS + threadIdx.x * 8;
  const int n = valid_slots(row_nnz, sparse, m, E);
  for (int e = threadIdx.x; e < n; e += H2D_THREADS) {
    s_v[e] = vals[(size_t)m * E + e];
    s_i[e] = idx[(size_t)m * E + e];
  }
  __syncthreads();
  if (k0 >= K) return;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = 0; e < n; ++e) {
    float wr[8];
    load8(w + (size_t)s_i[e] * K + k0, wr);
    const float v = s_v[e];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(v, wr[j], acc[j]);
  }
  float4* dst = reinterpret_cast<float4*>(y + (size_t)m * K + k0);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <typename T>
__global__ void __launch_bounds__(D2H_WARPS * 32)
    d2h_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               const int* __restrict__ idx, const int* __restrict__ row_nnz,
               const uint8_t* __restrict__ sparse, float* __restrict__ vals,
               int E, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);  // [K]
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = valid_slots(row_nnz, sparse, m, E);
  for (int e = n + threadIdx.x; e < E; e += blockDim.x)
    vals[(size_t)m * E + e] = 0.f;  // invalid slots
  if (n == 0) return;
  for (int k = threadIdx.x * 8; k < K; k += blockDim.x * 8) {
    if (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(s_x + k) =
          *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
    } else {
      reinterpret_cast<float4*>(s_x + k)[0] =
          reinterpret_cast<const float4*>(x + (size_t)m * K + k)[0];
      reinterpret_cast<float4*>(s_x + k)[1] =
          reinterpret_cast<const float4*>(x + (size_t)m * K + k)[1];
    }
  }
  __syncthreads();
  for (int e = warp; e < n; e += D2H_WARPS) {
    const T* wr = wt + (size_t)idx[(size_t)m * E + e] * K;
    float s = 0.f;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      float a[8], b[8];
      load8(s_x + k, a);
      load8(wr + k, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(a[j], b[j], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) vals[(size_t)m * E + e] = s;
  }
}

}  // namespace

// vals (M, E) f32, idx (M, E) int32, row_nnz (M,) int32, sparse (M,) uint8
// (bool), w (N, K) bf16 (w_bf16 != 0) or f32 -> y (M, K) f32.
// Requires K % 8 == 0 and E <= 1024.
extern "C" int hybrid_to_dense(const void* vals, const void* idx,
                               const void* row_nnz, const void* sparse,
                               const void* w, void* y, int M, int E, int K,
                               int w_bf16, void* stream) {
  dim3 grid(M, (K + H2D_COLS - 1) / H2D_COLS);
  cudaStream_t s = (cudaStream_t)stream;
  if (w_bf16)
    h2d_kernel<bf16><<<grid, H2D_THREADS, 0, s>>>(
        (const float*)vals, (const int*)idx, (const int*)row_nnz,
        (const uint8_t*)sparse, (const bf16*)w, (float*)y, E, K);
  else
    h2d_kernel<float><<<grid, H2D_THREADS, 0, s>>>(
        (const float*)vals, (const int*)idx, (const int*)row_nnz,
        (const uint8_t*)sparse, (const float*)w, (float*)y, E, K);
  return (int)cudaGetLastError();
}

// x (M, K), wt (N, K) both bf16 (bf16 != 0) or both f32; idx (M, E) int32,
// row_nnz (M,) int32, sparse (M,) uint8 -> vals (M, E) f32.
// Requires K % 8 == 0.
extern "C" int dense_to_hybrid(const void* x, const void* wt, const void* idx,
                               const void* row_nnz, const void* sparse,
                               void* vals, int M, int E, int K, int bf16_in,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)K * (bf16_in ? 2 : 4);
  cudaError_t e;
  if (bf16_in) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(d2h_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    d2h_kernel<bf16><<<M, D2H_WARPS * 32, smem, s>>>(
        (const bf16*)x, (const bf16*)wt, (const int*)idx, (const int*)row_nnz,
        (const uint8_t*)sparse, (float*)vals, E, K);
  } else {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(d2h_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    d2h_kernel<float><<<M, D2H_WARPS * 32, smem, s>>>(
        (const float*)x, (const float*)wt, (const int*)idx,
        (const int*)row_nnz, (const uint8_t*)sparse, (float*)vals, E, K);
  }
  return (int)cudaGetLastError();
}
