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
// K8 (the paper's CUDA-core branch of Algorithm 3, K2's gather loop). What
// bounds it on the H100: bytes. At the training shape (M = 8192 tokens,
// ELL width 128, ~100 valid slots a row, K = 2048) it writes an f32 (M, K)
// output and reads a W row of 4 KB per valid slot; the few hundred
// distinct rows a batch touches stay in the 50 MB L2. A row's valid slots
// are a prefix of its ELL row (pack compacts them in order), so a block
// loops over that prefix and never visits an empty slot: grid (row,
// 1024-column slice of y); the block stages the row's slot values and
// indices in shared memory, then each thread keeps 8 f32 accumulators of y
// in registers and walks the slots in order with one 16-byte load of W's
// row per slot (coalesced, W read by contiguous rows). Slot values in f32
// (the wrapper widens bf16 values; bf16 -> f32 is exact), W bf16 or f32.
//
// K9 in bf16 (d2h_union_kernel). What bounds it: at the training shape
// (M 8192, K 2048, N 5632, ELL width 128, ~108 valid slots a row over the
// 216 live columns) reading x, 33.5 MB, is 10 us at 3.35 TB/s, and the
// products over the live columns, 8192 x 216 x 2048 x 2 = 7.2 GFLOP, are
// 7 us at the bf16 tensor-core peak. A kernel that takes one row at a
// time reads a 4 KB Wt row per slot (3.6 GB through L2 a call) and does
// the dot products on CUDA cores. The Pallas kernel runs a dense (row
// block x N tile) product on the MXU and picks the pattern's entries; this
// kernel does the same with the columns no row of the block uses left out:
//   * grid (row block of BM = 128 rows, split s of S), two warpgroups a
//     block. The block reads its slots' indices (one contiguous range)
//     through shared memory with cp.async, all in flight at once, marks
//     the valid slots' columns in a byte map of N (plain byte stores:
//     every writer stores 1), folds it into a bitmap by warp ballots and
//     takes a prefix popcount over the bitmap's words: the union's U
//     columns in ascending order, and each column's position among them.
//     All on the card: the host never reads the pattern;
//   * the union is cut into chunks of UN = 128 columns; block s takes
//     chunks s, s + S, ... and exits at once when it has none. S and the
//     ring depth come from the host plan (kernels/hybrid_matmul.py:
//     d2h_plan, from shapes and the SM count);
//   * a chunk is a dense product: per 64-deep stage, x's (BM x 64) tile
//     and the chunk's UN Wt rows gathered by index, both K-major, copied by
//     every thread with cp.async in 16-byte pieces into 128B-swizzled
//     panels (zero-filled past M, past U and past K; Hopper's TMA has no
//     gather, and x's tile by TMA measured no faster) through a ring of
//     stages, two fewer ahead than it holds; wgmma m64n128k16 (bf16 in,
//     f32 accumulators), one warpgroup per 64 rows, one wgmma group kept in
//     flight behind the next stage's copies. While a block has two chunks
//     left, one pass takes both (x's tile read once for 256 columns, two
//     accumulator sets), where the ring holds three such stages;
//   * the pick: the pass's (BM x UN) accumulators are staged in the
//     drained ring, the indices read again through the rest of it, and
//     each valid slot whose column's position falls in a chunk of the pass
//     writes its value. The
//     block with s = 0 writes the zeros of every other slot (past row_nnz,
//     backup rows, an index outside [0, N)). So one block writes each
//     slot, and each value is one wgmma chain in a fixed K order: no
//     atomics, the same bits every run;
//   * the worst case, a union of all N, is a dense bf16 product x @ W on
//     the tensor cores, x's tile read once per chunk.
// Every branch around a wgmma depends only on values uniform over the
// block (U, K); the accumulators' zeroing is fenced off (fence_regs).
//
// K9 in float32 (d2h_f32_kernel, CUDA cores; the float32 gradient checks
// run it): grid (row); the block stages x's row in shared memory, each
// warp takes every fourth slot and forms the dot product with Wt's row by
// 16-byte loads and a shuffle reduction in f32. bf16 wgmma cannot take f32
// inputs exactly, and tf32 keeps too few bits for those checks.
#include <type_traits>

#include "sm90_common.cuh"

using namespace sm90;

namespace {

constexpr int H2D_THREADS = 128;
constexpr int H2D_COLS = 8 * H2D_THREADS;  // y columns per block
constexpr int D2H_WARPS = 4;               // the f32 K9 kernel's warps
constexpr int MAX_E = 1024;                // ELL width the kernels take

// K9's bf16 kernel
constexpr int UN = 128;                    // union columns a chunk: wgmma N
constexpr int BK = 64;                     // K of a ring stage: a panel row
constexpr int SROW = UN + 8;  // a staged accumulator row, in floats: the
                              // pad keeps the float2 stores conflict-free

constexpr int BM = 128;       // rows a block: two warpgroups of 64
struct D2h {
  static constexpr int THREADS = 2 * BM;
  static constexpr int WARPS = THREADS / 32;
  static constexpr uint32_t A = BM * PANEL_ROW;        // x: BM rows x BK
  static constexpr uint32_t B = UN * PANEL_ROW;        // Wt: UN rows x BK
  static constexpr uint32_t STAGE = A + B;             // a stage of one chunk
  static constexpr int RSTEP = THREADS / 8;  // rows between a thread's pieces
  static constexpr int AJ = BM / RSTEP;      // a thread's pieces of x
  static constexpr int BJ = UN / RSTEP;      // a thread's pieces of Wt
};

// dynamic shared memory of d2h_union_kernel<nst> at N columns (the
// host plan computes the same): 1 KB of alignment slack, the ring (the
// staged accumulators are aliased over it), the union's columns [N], the
// bitmap and its prefix [NW] each, the byte map [32 NW], the rows' valid
// slot counts [BM] and U
inline size_t d2h_smem(int nst, int N) {
  const size_t nw = (N + 31) / 32;
  return 1024 + (size_t)nst * D2h::STAGE + 4 * (size_t)N + 40 * nw + 4 * BM +
         16;
}

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

template <int NST>
__global__ void __launch_bounds__(D2h::THREADS, 1)
    d2h_union_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     const int* __restrict__ idx,
                     const int* __restrict__ row_nnz,
                     const uint8_t* __restrict__ sparse,
                     float* __restrict__ vals, int M, int E, int K, int N) {
  typedef D2h L;
  extern __shared__ __align__(1024) uint8_t smem_d2h[];
  const int NW = (N + 31) / 32;
  uint8_t* ring = smem_aligned(smem_d2h);               // [NST] stages
  int* cols = reinterpret_cast<int*>(ring + NST * L::STAGE);  // [N]
  uint32_t* bits = reinterpret_cast<uint32_t*>(cols + N);     // [NW]
  int* pre = reinterpret_cast<int*>(bits + NW);               // [NW]
  uint32_t* flags32 = reinterpret_cast<uint32_t*>(pre + NW);  // [8 NW]
  uint8_t* flags = reinterpret_cast<uint8_t*>(flags32);       // [32 NW]
  int* nv = reinterpret_cast<int*>(flags32 + 8 * NW);         // [BM]
  int* u_s = nv + BM;
  float* stg = reinterpret_cast<float*>(ring);  // [P][BM][SROW] after a pass

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, s = blockIdx.y, S = gridDim.y;
  const int rv = min(BM, M - m0);  // the block's rows
  // The block's slots, rv rows of E, are one contiguous range of idx. They
  // are read through shared memory in pieces of whole rows, each piece
  // copied with cp.async (every piece in flight at once, 16 bytes when
  // aligned), then fn(r, e, col) is called for every slot of the piece:
  // col is idx[m0 + r, e] on a valid slot, -1 past the row's valid slots.
  const int* bidx = idx + (size_t)m0 * E;
  const bool vec = E % 4 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  auto each_slot = [&](int* buf, int cap, auto&& fn) {
    const int per = cap / E;  // rows a piece (pass's static_asserts: a
                              // row of MAX_E fits beside the staging)
    for (int r_lo = 0; r_lo < rv; r_lo += per) {
      const int cnt = min(per, rv - r_lo) * E;
      const int* src = bidx + (size_t)r_lo * E;
      if (vec)
        for (int i = 4 * tid; i < cnt; i += 4 * L::THREADS)
          cp_async16(smem_u32(buf + i), src + i, true);
      else
        for (int i = tid; i < cnt; i += L::THREADS)
          cp_async4(smem_u32(buf + i), src + i);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int r = warp; r < min(per, rv - r_lo); r += L::WARPS) {
        const int n = nv[r_lo + r];
        for (int e = lane; e < E; e += 32)
          fn(r_lo + r, e, e < n ? buf[r * E + e] : -1);
      }
      __syncthreads();  // the piece is read before the next one lands
    }
  };

  // the rows' valid slots; the byte map cleared
  for (int r = tid; r < BM; r += L::THREADS)
    nv[r] = r < rv ? valid_slots(row_nnz, sparse, m0 + r, E) : 0;
  for (int w = tid; w < 8 * NW; w += L::THREADS) flags32[w] = 0u;
  __syncthreads();
  // the valid slots' columns marked (the ring is free: pieces of the whole
  // ring); split 0 zeroes every other slot
  each_slot(reinterpret_cast<int*>(ring), NST * L::STAGE / 4,
            [&](int r, int e, int col) {
              if ((unsigned)col < (unsigned)N)
                flags[col] = 1;
              else if (s == 0)
                vals[(size_t)(m0 + r) * E + e] = 0.f;
            });
  // the bitmap: bit b of word w is column 32 w + b
  for (int w = warp; w < NW; w += L::WARPS) {
    const uint32_t b = __ballot_sync(0xffffffffu, flags[32 * w + lane] != 0);
    if (lane == 0) bits[w] = b;
  }
  __syncthreads();
  // prefix popcount (warp 0): pre[w] = the union's columns below word w
  if (warp == 0) {
    const int per = (NW + 31) / 32;
    const int lo = min(lane * per, NW), hi = min(lo + per, NW);
    int cnt = 0;
    for (int w = lo; w < hi; ++w) cnt += __popc(bits[w]);
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    int run = inc - cnt;
    for (int w = lo; w < hi; ++w) {
      pre[w] = run;
      run += __popc(bits[w]);
    }
    if (lane == 31) *u_s = inc;
  }
  __syncthreads();
  const int U = *u_s;
  const int chunks = (U + UN - 1) / UN;
  if (s >= chunks) return;  // uniform over the block
  // the union's columns in ascending order
  for (int w = tid; w < NW; w += L::THREADS) {
    uint32_t b = bits[w];
    int p = pre[w];
    while (b) {
      cols[p++] = 32 * w + __ffs(b) - 1;
      b &= b - 1;
    }
  }
  __syncthreads();

  // a thread copies 16-byte piece ch of rows r0 + j RSTEP of the tiles
  const int ch = tid % 8, r0 = tid / 8;
  const int kt_n = (K + BK - 1) / BK;
  const uint32_t ring_a = smem_u32(ring);
  // accumulator element 4j + 2h + e of this thread: row 16 wwarp + g8 + 8h
  // of its warpgroup's 64, column 8j + c2 + e of the chunk
  const int wg = tid / 128, wwarp = (tid % 128) / 32;
  const int g8 = lane / 4, c2 = (lane % 4) * 2;

  // one pass over K for P chunks, c0 and (P = 2) c0 + S: a stage holds
  // x's tile and each chunk's Wt rows, so x is read once for P x UN
  // columns; the ring's bytes hold SL such stages
  auto pass = [&](auto p_const, int c0) {
    constexpr int P = decltype(p_const)::value;
    constexpr uint32_t ST = L::A + P * L::B;
    constexpr int SL = NST * L::STAGE / ST;
    constexpr int AH = SL - 2;  // stages copied ahead of the one computed
    static_assert(AH >= 1, "the ring holds the stage in flight");
    static_assert(P * BM * SROW * 4 + 4 * MAX_E <= NST * L::STAGE,
                  "staging and one row of indices fit the ring");
    int colr[P][L::BJ];
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int j = 0; j < L::BJ; ++j) {
        const int lo = (c0 + q * S) * UN, p = lo + r0 + j * L::RSTEP;
        colr[q][j] = p < min(lo + UN, U) ? cols[p] : -1;
      }
    // stage kt of the K loop into ring slot st: x's rows and the chunks'
    // Wt rows, zero past M, past U and past K
    auto issue = [&](int kt, int st) {
      const uint32_t a_dst = ring_a + st * ST;
      const int k = kt * BK + ch * 8;
      const bool kok = k < K;
#pragma unroll
      for (int j = 0; j < L::AJ; ++j) {
        const int r = r0 + j * L::RSTEP;
        const bool ok = kok && m0 + r < M;
        cp_async16(a_dst + sw128_off(r, ch),
                   x + (ok ? (size_t)(m0 + r) * K + k : 0), ok);
      }
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int j = 0; j < L::BJ; ++j) {
          const bool ok = kok && colr[q][j] >= 0;
          cp_async16(a_dst + L::A + q * L::B +
                         sw128_off(r0 + j * L::RSTEP, ch),
                     wt + (ok ? (size_t)colr[q][j] * K + k : 0), ok);
        }
    };
    float acc[P][UN / 2];
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int i = 0; i < UN / 2; ++i) acc[q][i] = 0.f;
      fence_regs<UN / 2>(acc[q]);
    }
#pragma unroll
    for (int a = 0; a < AH; ++a) {
      if (a < kt_n) issue(a, a);
      cp_async_commit();
    }
    for (int it = 0; it < kt_n; ++it) {
      cp_async_wait<AH - 1>();  // this thread's copies of stage it landed
      fence_proxy_async();
      // every thread's copies landed; the wgmmas of stage it - 2, the slot
      // the next copies go to, are complete in both warpgroups
      __syncthreads();
      if (it + AH < kt_n) issue(it + AH, (it + AH) % SL);
      cp_async_commit();
      const uint32_t a_s = ring_a + (it % SL) * ST;
      const uint32_t a_w = a_s + wg * 64 * PANEL_ROW;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < P; ++q)
          WgmmaKA<UN>::mma(acc[q], sw128_desc(a_w + kk * 32, 0),
                           sw128_desc(a_s + L::A + q * L::B + kk * 32, 0));
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < P; ++q) fence_regs<UN / 2>(acc[q]);
    cp_async_wait<0>();
    __syncthreads();  // both warpgroups' wgmmas done: the ring is free
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int j = 0; j < UN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + 16 * wwarp + g8 + 8 * h;
          *reinterpret_cast<float2*>(stg + (q * BM + r) * SROW + 8 * j +
                                     c2) =
              make_float2(acc[q][4 * j + 2 * h], acc[q][4 * j + 2 * h + 1]);
        }
    __syncthreads();
    // the pick: each valid slot whose column lies in one of the chunks,
    // its indices read through the ring past the staged accumulators
    each_slot(reinterpret_cast<int*>(stg + P * BM * SROW),
              (NST * L::STAGE - P * BM * SROW * 4) / 4,
              [&](int r, int e, int col) {
                if ((unsigned)col >= (unsigned)N) return;
                const int w = col >> 5;
                const int p =
                    pre[w] + __popc(bits[w] & ((1u << (col & 31)) - 1u));
#pragma unroll
                for (int q = 0; q < P; ++q)
                  if (p / UN == c0 + q * S)
                    vals[(size_t)(m0 + r) * E + e] =
                        stg[(q * BM + r) * SROW + p % UN];
              });
  };

  // the block's chunks s, s + S, ...: two a pass while two remain and the
  // ring holds three stages of two, then one
  int c = s;
  if constexpr (NST * L::STAGE / (L::A + 2 * L::B) >= 3)
    for (; c + S < chunks; c += 2 * S)
      pass(std::integral_constant<int, 2>{}, c);
  for (; c < chunks; c += S) pass(std::integral_constant<int, 1>{}, c);
}

__global__ void __launch_bounds__(D2H_WARPS * 32)
    d2h_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const int* __restrict__ idx,
                   const int* __restrict__ row_nnz,
                   const uint8_t* __restrict__ sparse,
                   float* __restrict__ vals, int E, int K) {
  extern __shared__ __align__(16) float s_x[];  // [K]
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = valid_slots(row_nnz, sparse, m, E);
  for (int e = n + threadIdx.x; e < E; e += blockDim.x)
    vals[(size_t)m * E + e] = 0.f;  // invalid slots
  if (n == 0) return;
  for (int k = threadIdx.x * 8; k < K; k += blockDim.x * 8) {
    reinterpret_cast<float4*>(s_x + k)[0] =
        reinterpret_cast<const float4*>(x + (size_t)m * K + k)[0];
    reinterpret_cast<float4*>(s_x + k)[1] =
        reinterpret_cast<const float4*>(x + (size_t)m * K + k)[1];
  }
  __syncthreads();
  for (int e = warp; e < n; e += D2H_WARPS) {
    const float* wr = wt + (size_t)idx[(size_t)m * E + e] * K;
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

template <int NST>
int launch_union(const void* x, const void* wt, const void* idx,
                 const void* row_nnz, const void* sparse, void* vals, int M,
                 int E, int K, int N, int splits, size_t smem,
                 cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      d2h_union_kernel<NST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  d2h_union_kernel<NST>
      <<<dim3((M + BM - 1) / BM, splits), D2h::THREADS, smem, st>>>(
          (const bf16*)x, (const bf16*)wt, (const int*)idx,
          (const int*)row_nnz, (const uint8_t*)sparse, (float*)vals, M, E, K,
          N);
  return (int)cudaGetLastError();
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

// x (M, K), wt (N, K) both bf16 (bf16_in != 0) or both f32; idx (M, E)
// int32, row_nnz (M,) int32, sparse (M,) uint8 -> vals (M, E) f32.
// Requires K % 8 == 0. bf16: the plan's splits S, ring depth (4-6) and
// dynamic shared memory (at least d2h_smem); float32 ignores them.
extern "C" int dense_to_hybrid(const void* x, const void* wt, const void* idx,
                               const void* row_nnz, const void* sparse,
                               void* vals, int M, int E, int K, int N,
                               int bf16_in, int splits, int stages, int smem,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16_in) {
    const size_t bytes = (size_t)K * 4;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          d2h_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    d2h_f32_kernel<<<M, D2H_WARPS * 32, bytes, s>>>(
        (const float*)x, (const float*)wt, (const int*)idx,
        (const int*)row_nnz, (const uint8_t*)sparse, (float*)vals, E, K);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || N < 1 || smem < 0 || (size_t)smem < d2h_smem(stages, N))
    return (int)cudaErrorInvalidValue;
#define D2H_UNION(NST_)                                                   \
  if (stages == NST_)                                                     \
    return launch_union<NST_>(x, wt, idx, row_nnz, sparse, vals, M, E, K, \
                              N, splits, smem, s);
  D2H_UNION(4)
  D2H_UNION(5)
  D2H_UNION(6)
#undef D2H_UNION
  return (int)cudaErrorInvalidValue;
}
