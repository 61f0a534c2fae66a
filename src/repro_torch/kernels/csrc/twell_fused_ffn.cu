// K2: fused up + down projection from the packed TwELL gate (paper Eq. 3).
//
// Replaces src/repro/kernels/sparse_ffn.py:50 twell_fused_ffn_pallas (its
// _kernel): y = (x @ W_u * unpack(g)) @ W_d, with h_u never written to
// device memory.
//
// Form: the paper's gather form (core/twell.py fused_ffn_reference). For
// each active slot (n, v) of row m:  hu = x[m] . W_u[:, n];
// y[m, :] += bf16(v * hu) * W_d[n, :]  (the bf16 rounding of h mirrors the
// Pallas kernel's h.astype(x.dtype) before its down-projection dot).
//
// What bounds it on the H100: bytes. Only the active columns of W_u and the
// active rows of W_d are read -- at the ~1% density of the paper's regime,
// about 56 columns per row, 2 x 56 x 4 KB -- plus x and the packed gate.
// The flops (4*K per active slot) are small beside that.
//
// Design:
//   * W_u is read by column; its (K, N) row-major layout would make each
//     column a strided walk, so the caller passes W_u^T (N, K), a copy made
//     once when the weights are loaded (lm.prepare_params), never per call;
//   * grid (row, K-slice of 256): each block compacts its row's active
//     slots in stable order (all warps ballot 32-slot chunks in parallel,
//     offsets from a prefix over the chunk counts), recomputes that row's
//     few h_u dot products (warp per slot, 16-byte loads, shuffle
//     reduction; the repeats across K-slices hit L2), then accumulates its
//     y slice with one thread per output column over the slots in order.
//     The reduction over slots stays inside the block and needs no float
//     atomics, so y is the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;  // = the K-slice width
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot of two bf16 rows of length K (K % 8 == 0), one warp, f32 sum
__device__ __forceinline__ float row_dot(const bf16* __restrict__ a,
                                         const bf16* __restrict__ b, int K,
                                         int lane) {
  float s = 0.f;
#pragma unroll 8
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + k);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + k);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(pa[j]);
      const float2 fb = __bfloat1622float2(pb[j]);
      s = fmaf(fa.x, fb.x, s);
      s = fmaf(fa.y, fb.y, s);
    }
  }
  return warp_sum(s);
}

__device__ __forceinline__ bool slot_valid(const int* __restrict__ nnz,
                                           int m, int s, int slots, int nt,
                                           int tc) {
  return s < slots && (s % tc) < nnz[(size_t)m * nt + s / tc];
}

__global__ void __launch_bounds__(NTHREADS)
    fused_ffn_kernel(const bf16* __restrict__ vals, const int* __restrict__ idx,
                     const int* __restrict__ nnz, const bf16* __restrict__ x,
                     const bf16* __restrict__ wu_t,
                     const bf16* __restrict__ wd, float* __restrict__ y,
                     int K, int nt, int tc) {
  extern __shared__ unsigned char smem_raw[];
  const int slots = nt * tc;
  const int nchunk = (slots + 31) / 32;
  int* s_col = reinterpret_cast<int*>(smem_raw);             // [slots]
  float* s_h = reinterpret_cast<float*>(s_col + slots);      // [slots]
  int* s_off = reinterpret_cast<int*>(s_h + slots);          // [nchunk]
  __shared__ int s_count;

  const int m = blockIdx.x;
  const int k = blockIdx.y * NTHREADS + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;

  // 1. compact the row's valid slots (slot j of tile t is valid iff
  //    j < nnz[m, t]) in stable order: every warp counts its 32-slot chunks
  //    by ballot, one thread turns the counts into offsets, then every warp
  //    writes its chunks' slots at their offsets
  for (int c = warp; c < nchunk; c += NWARPS) {
    const unsigned bits = __ballot_sync(
        0xffffffffu, slot_valid(nnz, m, c * 32 + lane, slots, nt, tc));
    if (lane == 0) s_off[c] = __popc(bits);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c < nchunk; ++c) {
      const int n = s_off[c];
      s_off[c] = run;
      run += n;
    }
    s_count = run;
  }
  __syncthreads();
  for (int c = warp; c < nchunk; c += NWARPS) {
    const int s = c * 32 + lane;
    const bool ok = slot_valid(nnz, m, s, slots, nt, tc);
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int pos = s_off[c] + __popc(bits & lt);
      s_col[pos] = idx[(size_t)m * slots + s];
      s_h[pos] = __bfloat162float(vals[(size_t)m * slots + s]);
    }
  }
  __syncthreads();
  const int count = s_count;

  // 2. h = bf16(v * (x[m] . W_u[:, n])) for each active slot
  const bf16* xr = x + (size_t)m * K;
  for (int p = warp; p < count; p += NWARPS) {
    const float hu = row_dot(xr, wu_t + (size_t)s_col[p] * K, K, lane);
    if (lane == 0)
      s_h[p] = __bfloat162float(__float2bfloat16(s_h[p] * hu));
  }
  __syncthreads();

  // 3. y[m, k] = sum over slots, in order, of h * W_d[n, k]
  if (k < K) {
    float acc = 0.f;
#pragma unroll 8
    for (int p = 0; p < count; ++p)
      acc = fmaf(s_h[p], __bfloat162float(wd[(size_t)s_col[p] * K + k]), acc);
    y[(size_t)m * K + k] = acc;
  }
}

}  // namespace

// vals/idx (M, N/C) bf16/int32, nnz (M, N/T) int32 (clipped to T/C),
// x (M, K) bf16, wu_t (N, K) bf16 (= W_u transposed), wd (N, K) bf16;
// y (M, K) float32. Requires K % 8 == 0.
extern "C" int twell_fused_ffn_bf16(const void* vals, const void* idx,
                                    const void* nnz, const void* x,
                                    const void* wu_t, const void* wd, void* y,
                                    int M, int K, int N, int T, int C,
                                    void* stream) {
  const int nt = N / T, tc = T / C;
  const size_t slots = (size_t)nt * tc;
  const size_t smem = slots * (sizeof(int) + sizeof(float)) +
                      (slots + 31) / 32 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(M, (K + NTHREADS - 1) / NTHREADS);
  fused_ffn_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)vals, (const int*)idx, (const int*)nnz, (const bf16*)x,
      (const bf16*)wu_t, (const bf16*)wd, (float*)y, K, nt, tc);
  return (int)cudaGetLastError();
}
