// K4: paged chunk-append attention (prefill / chunked prefill).
//
// Replaces src/repro/kernels/paged_chunk_attention.py:78
// paged_chunk_attention_pallas (its _chunk_kernel): each request appends
// num_new tokens at positions seq_len .. seq_len + num_new - 1 (their K/V
// already scattered into the pools); chunk row i attends the request's whole
// paged history plus the chunk causally (kpos <= seq_len + i).
//
// What bounds it on the H100: bytes at serving sizes -- each live K/V row is
// read once per (request, kv head); at a 64-token chunk over a 512-token
// history the 4 * rows * keys * hd flops are below the bf16 ridge point,
// provided they run on the tensor cores.
//
// Design (flash-attention form on mma.sync):
//   * grid (request, kv head, tile of 64 query rows of the G*S rows): row
//     j is head group g = j / S, chunk offset i = j % S (head h = hkv*G + g),
//     query position seq_len + i -- GQA without repeat_kv, as the Pallas
//     kernel lays its rows out; each of the four warps owns 16 rows, its Q
//     held in registers as mma A fragments;
//   * the block caches its request's block table in shared memory and
//     stages 64 keys at a time through it: 16-byte loads into registers one
//     tile ahead, so the next tile's loads overlap this tile's math, then K
//     row-major and V transposed in shared memory, both bf16, rows padded
//     against bank conflicts. It walks only keys up to the last one any of
//     its rows can see, min(seq_len + num_new - 1, its largest query
//     position);
//   * S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//     accumulation; the f32 online softmax runs on the accumulator
//     fragments (a row's 64 scores live in 4 lanes, reduced by two
//     shuffles), and P goes to the second product rounded to bf16, as the
//     reference casts its probabilities to the query dtype;
//   * output acc / max(l, 1e-30) in bf16: a row with no live key (num_new =
//     0 and an empty history: a padded batch row) is exactly zero.
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
    chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                 const bf16* __restrict__ vpool, const int* __restrict__ bt,
                 const int* __restrict__ seq_lens,
                 const int* __restrict__ num_new, bf16* __restrict__ out,
                 int S, int hkv, int G, int hd, int bs, int width,
                 float scale) {
  constexpr int KS = HD + 8;   // K row stride (elements)
  constexpr int QK = HD / 16;  // k-steps of Q K^T
  constexpr int DN = HD / 8;   // 8-wide output blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);       // [KT][KS]
  bf16* vt_s = k_s + KT * KS;                          // [HD][VS]
  int* bt_s = reinterpret_cast<int*>(vt_s + HD * VS);  // [width]

  const int b = blockIdx.x, h = blockIdx.y;
  const int j0 = blockIdx.z * RT;
  const int nrows = min(RT, G * S - j0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = hkv * G;
  const int sl = seq_lens[b];
  const int last = sl + num_new[b] - 1;  // < sl when num_new == 0

  for (int e = tid; e < width; e += blockDim.x)
    bt_s[e] = bt[(size_t)b * width + e];
  // zero the padded head dims once; tiles rewrite only dims < hd
  for (int e = tid; e < KT * KS; e += blockDim.x)
    k_s[e] = __float2bfloat16(0.f);
  for (int e = tid; e < HD * VS; e += blockDim.x)
    vt_s[e] = __float2bfloat16(0.f);

  // this thread's two rows (gid and gid + 8 of the warp's 16): query
  // position (clamped below) and the Q fragments, zero past hd / nrows
  int qpos[2];
  uint32_t qa[QK][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = warp * 16 + gid + 8 * half;
    const int j = j0 + rr, g = j / S, i = j % S;
    const bool live = rr < nrows;
    qpos[half] = live ? sl + i : -1;
    const bf16* qr = q + (((size_t)b * S + i) * H + h * G + g) * hd;
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int d = kk * 16 + 8 * hi + tig * 2;
        uint32_t v = 0;
        if (live && d < hd) v = *reinterpret_cast<const uint32_t*>(qr + d);
        qa[kk][half + 2 * hi] = v;  // a0/a1: cols 0-7, a2/a3: cols 8-15
      }
    }
  }
  int max_i = 0;
  for (int r = 0; r < nrows; ++r) max_i = max(max_i, (j0 + r) % S);
  const int kend = min(min(last, sl + max_i) + 1, width * bs);
#pragma unroll
  for (int half = 0; half < 2; ++half) qpos[half] = min(qpos[half], kend - 1);

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
        const size_t off = (((size_t)bt_s[pos / bs] * bs + pos % bs) * hkv +
                            h) * hd + (e % cpk) * 8;
        kpf[c] = *reinterpret_cast<const uint4*>(kpool + off);
        vpf[c] = *reinterpret_cast<const uint4*>(vpool + off);
      }
    }
  };
  __syncthreads();  // bt_s and the zero fill are visible
  if (kend > 0) fetch(0);
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
          float& v = s[nb][2 * half + c];
          v = key <= qpos[half] ? v * scale : NEG;
          mx = fmaxf(mx, v);
        }
      mx = group_max(mx);
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = s[nb][2 * half + c];
          v = v > NEG ? expf(v - m_new) : 0.f;  // masked keys: exactly 0
          sum += v;
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
    const int rr = warp * 16 + gid + 8 * half;
    if (rr >= nrows) continue;
    const int j = j0 + rr, g = j / S, i = j % S;
    const float inv = 1.f / fmaxf(l[half], 1e-30f);
    bf16* dst = out + (((size_t)b * S + i) * H + h * G + g) * hd;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* bt, const void* seq_lens, const void* num_new,
           void* out, int B, int S, int hkv, int G, int hd, int bs, int width,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (KT * (HD + 8) + HD * VS) +
                      sizeof(int) * width;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, hkv, (G * S + RT - 1) / RT);
  chunk_kernel<HD><<<grid, NWARPS * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)kpool, (const bf16*)vpool, (const int*)bt,
      (const int*)seq_lens, (const int*)num_new, (bf16*)out, S, hkv, G, hd,
      bs, width, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd) bf16; kpool/vpool (N, bs, Hkv, hd) bf16; block_tables
// (B, W) int32; seq_lens, num_new (B,) int32; out (B, S, H, hd) bf16.
// Requires hd % 8 == 0 and hd <= 128.
extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* kpool, const void* vpool, const void* bt,
    const void* seq_lens, const void* num_new, void* out, int B, int S, int H,
    int hkv, int hd, int bs, int width, float scale, void* stream) {
  const int G = H / hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32)
    return launch<32>(q, kpool, vpool, bt, seq_lens, num_new, out, B, S, hkv,
                      G, hd, bs, width, scale, s);
  if (hd <= 64)
    return launch<64>(q, kpool, vpool, bt, seq_lens, num_new, out, B, S, hkv,
                      G, hd, bs, width, scale, s);
  return launch<128>(q, kpool, vpool, bt, seq_lens, num_new, out, B, S, hkv,
                     G, hd, bs, width, scale, s);
}
