// K7: causal flash attention (the training forward's self-attention).
//
// Replaces src/repro/kernels/flash_attention.py:58 flash_attention_pallas
// (its _kernel): o = softmax(q k^T * scale, causal) v on (B, S, H, hd) with
// the same H for q, k and v, an f32 online softmax, and the KV blocks
// strictly in a query block's future skipped.
//
// What bounds it on the H100: at the training shape (B 8, S 1024, H 32,
// hd 64) reading q, k, v and writing o is 134 MB, 40 us at 3.35 TB/s; the
// causal 2 * S^2 * hd * B * H = 34 GFLOP take 35 us at the bf16 tensor-core
// peak. Both are near, so the products must run on the tensor cores and
// each K/V row should be read from device memory about once per query tile.
//
// Design (kernel K4's flash form, with contiguous K/V in place of pages):
//   * grid (batch x head, tile of 64 query rows); each of the four warps
//     owns 16 rows, its Q held in registers as mma A fragments. The TPU
//     grid walks KV blocks in order with (m, l, acc) in VMEM scratch; here
//     the block loops over the key tiles itself, and only up to the
//     diagonal: the last key any of its rows can see is its last row;
//   * keys are staged 64 at a time: 16-byte loads into registers one tile
//     ahead (the next tile's loads overlap this tile's math), then K
//     row-major and V transposed in shared memory, bf16, rows padded
//     against bank conflicts;
//   * S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//     accumulation; the f32 online softmax runs on the accumulator
//     fragments (a row's 64 scores live in 4 lanes, reduced by two
//     shuffles); l sums the f32 probabilities and P enters the second
//     product rounded to bf16 -- the Pallas body's p.astype(v.dtype);
//   * output acc / max(l, 1e-30) rounded once to bf16.
// float32 inputs take a second, plain CUDA-core kernel (a warp per query
// row, 32-key tiles, f32 throughout): tensor-core TF32 would not hold the
// float32 tolerance; that path serves the tests, not the bf16 model.
// No atomics: each result is the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 4;
constexpr int RT = 16 * NWARPS;  // query rows per block
constexpr int KT = 64;           // keys per staged tile
constexpr int VS = KT + 8;       // transposed V row stride (elements)
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the max / sum of a row whose values sit in the 4 lanes of a lane group
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// HD: head dim padded to a multiple of 16 (32, 64 or 128)
template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int S, int H, int hd, float scale) {
  constexpr int KS = HD + 8;   // K row stride (elements)
  constexpr int QK = HD / 16;  // k-steps of Q K^T
  constexpr int DN = HD / 8;   // 8-wide output blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [KT][KS]
  bf16* vt_s = k_s + KT * KS;                     // [HD][VS]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t rs = (size_t)H * hd;               // one position's stride
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;

  // zero the padded head dims once; tiles rewrite only dims < hd
  for (int e = tid; e < KT * KS; e += blockDim.x)
    k_s[e] = __float2bfloat16(0.f);
  for (int e = tid; e < HD * VS; e += blockDim.x)
    vt_s[e] = __float2bfloat16(0.f);

  // this thread's two rows (gid and gid + 8 of the warp's 16): query
  // position (-1 past S) and the Q fragments, zero past hd / S
  int qpos[2];
  uint32_t qa[QK][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + gid + 8 * half;
    const bool live = row < S;
    qpos[half] = live ? row : -1;
    const bf16* qr = q + base + (size_t)row * rs;
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int d = kk * 16 + 8 * hi + tig * 2;
        uint32_t u = 0;
        if (live && d < hd) u = *reinterpret_cast<const uint32_t*>(qr + d);
        qa[kk][half + 2 * hi] = u;  // a0/a1: cols 0-7, a2/a3: cols 8-15
      }
    }
  }
  const int kend = min(S, q0 + RT);  // causal: no key past the last row

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // the next tile's K/V rows are fetched into registers while the current
  // tile is computed: CPT 16-byte chunks of each per thread
  constexpr int CPT = KT * HD / 8 / (NWARPS * 32);
  const int cpk = hd / 8;  // 16-byte chunks per key row
  uint4 kpf[CPT], vpf[CPT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid + c * NWARPS * 32;
      const int pos = k0 + e / cpk;
      kpf[c] = make_uint4(0, 0, 0, 0);
      vpf[c] = make_uint4(0, 0, 0, 0);
      if (e < KT * cpk && pos < kend) {
        const size_t off = base + (size_t)pos * rs + (e % cpk) * 8;
        kpf[c] = *reinterpret_cast<const uint4*>(k + off);
        vpf[c] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  __syncthreads();  // the zero fill is visible
  fetch(0);
  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid + c * NWARPS * 32;
      if (e < KT * cpk) {
        const int j = e / cpk, d0 = (e % cpk) * 8;
        *reinterpret_cast<uint4*>(k_s + j * KS + d0) = kpf[c];
        const bf16* vv = reinterpret_cast<const bf16*>(&vpf[c]);
#pragma unroll
        for (int t = 0; t < 8; ++t) vt_s[(d0 + t) * VS + j] = vv[t];
      }
    }
    __syncthreads();
    if (k0 + KT < kend) fetch(k0 + KT);  // in flight during this tile's math

    // S = Q K^T: 8 blocks of 8 keys, each 4 accumulators per thread
    float s[KT / 8][4];
#pragma unroll
    for (int nb = 0; nb < KT / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const bf16* kr = k_s + (nb * 8 + gid) * KS + tig * 2;
#pragma unroll
      for (int kk = 0; kk < QK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma16816(s[nb], qa[kk], b0, b1);
      }
    }
    // online softmax on the fragments: c0/c1 belong to row gid, c2/c3 to
    // row gid + 8; key of (nb, c) = k0 + nb*8 + tig*2 + (c & 1)
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = NEG;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + nb * 8 + tig * 2 + c;
          float& x = s[nb][2 * half + c];
          x = key <= qpos[half] ? x * scale : NEG;
          mx = fmaxf(mx, x);
        }
      mx = group_max(mx);
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nb][2 * half + c];
          x = x > NEG ? expf(x - m_new) : 0.f;  // masked keys: exactly 0
          sum += x;
        }
      corr[half] = expf(m[half] - m_new);
      l[half] = l[half] * corr[half] + group_sum(sum);
      m[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // O += P V: P's accumulator layout is the A-fragment layout of the next
    // product (keys 16 per k-step = blocks 2kk and 2kk+1)
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const bf16* vr = vt_s + (n * 8 + gid) * VS + kk * 16 + tig * 2;
        mma16816(o[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qpos[half] < 0) continue;
    const float inv = 1.f / fmaxf(l[half], 1e-30f);
    bf16* dst = out + base + (size_t)qpos[half] * rs;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

// float32: a warp per query row, lanes own keys for the scores and head
// dims (lane, lane + 32, ...) for the output; 32-key tiles in shared memory
constexpr int FW = 4;    // warps (= query rows) per block
constexpr int FKT = 32;  // keys per tile

__global__ void __launch_bounds__(FW * 32)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = hd + 1;                                   // padded stride
  float* k_s = reinterpret_cast<float*>(smem_raw);         // [FKT][ks]
  float* v_s = k_s + FKT * ks;                             // [FKT][hd]
  float* q_s = v_s + FKT * hd;                             // [FW][hd]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * FW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = (size_t)H * hd;
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;
  const int row = q0 + warp;
  const bool live = row < S;
  for (int d = lane; d < hd; d += 32)
    q_s[warp * hd + d] = live ? q[base + (size_t)row * rs + d] : 0.f;
  const int kend = min(S, q0 + FW);
  float m = NEG, l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kend; k0 += FKT) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < FKT * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd, pos = k0 + j;
      const bool in = pos < kend;
      k_s[j * ks + d] = in ? k[base + (size_t)pos * rs + d] : 0.f;
      v_s[j * hd + d] = in ? v[base + (size_t)pos * rs + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
    const bool ok = live && key <= row;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(q_s[warp * hd + d], k_s[lane * ks + d], s);
    s = ok ? s * scale : NEG;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float p = ok ? expf(s - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    const float corr = expf(m - m_new);
    l = l * corr + ps;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] *= corr;
    for (int j = 0; j < FKT; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) o[i] = fmaf(pj, v_s[j * hd + d], o[i]);
      }
    }
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[base + (size_t)row * rs + d] = o[i] * inv;
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int hd, float scale,
                cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (KT * (HD + 8) + HD * VS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * H, (S + RT - 1) / RT);
  flash_bf16_kernel<HD><<<grid, NWARPS * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, hd,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, S, H, hd) bf16; requires hd % 8 == 0 and hd <= 128.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int hd, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32) return launch_bf16<32>(q, k, v, out, B, S, H, hd, scale, s);
  if (hd <= 64) return launch_bf16<64>(q, k, v, out, B, S, H, hd, scale, s);
  return launch_bf16<128>(q, k, v, out, B, S, H, hd, scale, s);
}

// q, k, v, out (B, S, H, hd) float32; requires hd <= 128.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int hd, float scale, void* stream) {
  const size_t smem = sizeof(float) * (FKT * (hd + 1) + FKT * hd + FW * hd);
  dim3 grid(B * H, (S + FW - 1) / FW);
  flash_f32_kernel<<<grid, FW * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H,
      hd, scale);
  return (int)cudaGetLastError();
}
