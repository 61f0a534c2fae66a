// The Hopper core shared by K7 (flash_attention.cu) and K4
// (paged_chunk_attention.cu): one warpgroup (128 threads) owns 64 query
// rows and runs the flash-attention step on them with wgmma.
//
// Shared-memory tiles are 128-byte-swizzled panels of 64 bf16 columns
// (one 128-byte row per query or key, 8-row atoms of 1024 bytes, each panel
// 1024-aligned): the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and
// that sw128_off reproduces for copies made by threads. A head dim of 128
// is two panels. On such tiles:
//   * S = Q K^T: wgmma m64nKTk16, A = Q and B = K both from shared memory,
//     K-major (the head dim is contiguous), 16 head dims a step;
//   * O += P V: wgmma m64nHDk16, A = P in registers (the S accumulators
//     rounded to bf16 in place: the accumulator layout of one product is
//     the A-fragment layout of the next), B = the V tile as stored, read
//     MN-major (the transpose bit), 16 keys a step -- no transposed copy;
//   * the f32 online softmax runs on the accumulator registers, in base 2
//     with the scale folded in (scale * log2 e, one FFMA and one ex2 an
//     element); masked keys give exactly 0;
//   * software pipelining (flash_step): a tile's Q K^T is issued with the
//     previous tile's P V, and the softmax runs while that P V is on the
//     tensor cores; O is rescaled just before the P V that adds to it.
#pragma once
#include <math.h>

#include "sm90_common.cuh"

namespace sm90 {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// D (64 x 64, f32) {+}= A (64 x 16, shared, K-major) * B (64 x 16,
// shared, K-major)^T; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) {+}= A (64 x 16, shared, K-major) * B (128 x 16,
// shared, K-major)^T; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int sc) { wgmma_ss_n64(d, a, b, sc); }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) { wgmma_rs_n64(d, a, b); }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int sc) { wgmma_ss_n128(d, a, b, sc); }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) { wgmma_rs_n128(d, a, b); }
};

// ---- the flash-attention step of one warpgroup ---------------------------
//
// Accumulator layout of a 64 x N wgmma (thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, c = t % 4): element 4j + 2h + e holds row
// 16w + g + 8h, column 8j + 2c + e.

// Issues S (64 x KT) = Q K^T as one wgmma group. q: the warpgroup's HD/64
// panels of 64 rows; k: the tile's HD/64 panels of KT rows.
template <int KT, int HD>
__device__ __forceinline__ void qk_issue(float* s, uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    Wgmma<KT>::ss(s, sw128_desc(q + (kk / 4) * 64 * PANEL_ROW + off, 0),
                  sw128_desc(k + (kk / 4) * KT * PANEL_ROW + off, 0), kk > 0);
  }
  wgmma_commit();
}

// Issues O (64 x HD) += P V as one wgmma group. p: KT/16 A fragments; v:
// the tile's HD/64 panels of KT rows, read MN-major: 16 keys = 2048 bytes a
// step, panels KT rows apart.
template <int KT, int HD>
__device__ __forceinline__ void pv_issue(float* o, const uint32_t* p,
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    Wgmma<HD>::rs(o, p + 4 * kk,
                  sw128_desc(v + kk * 16 * PANEL_ROW, KT * PANEL_ROW));
  wgmma_commit();
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The f32 online softmax of one key tile, on the scores s of keys k0 ..
// k0 + KT - 1: s becomes the f32 probabilities in place, m and l of the
// thread's two rows are updated, and corr (the factor for everything
// accumulated before this tile) is returned; o is not touched. m is kept in
// base 2 (the row max times sl2 = scale * log2 e), so p = 2^(s sl2 - m) is
// one FFMA and one ex2. MASK: key > qpos[h] is masked to exactly 0 (qpos
// -1: the whole row).
template <int KT, bool MASK>
__device__ __forceinline__ void softmax_scores(float* s, float* m, float* l,
                                               float* corr, float sl2, int k0,
                                               const int* qpos) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (MASK && k0 + 8 * j + c2 + e > qpos[h]) x = NEG;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[h], group_max(mx) * sl2);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = (MASK && k0 + 8 * j + c2 + e > qpos[h]) ? 0.f
                                                    : ex2(fmaf(x, sl2, -m_new));
        sum += x;
      }
    corr[h] = ex2(m[h] - m_new);
    l[h] = l[h] * corr[h] + group_sum(sum);
    m[h] = m_new;
  }
}

// One key tile of a warpgroup's flash attention, software-pipelined:
// issue S = Q K^T of this tile (k: its K); when a tile is pending
// (PENDING: its P in p, its factor in corr) rescale O by that factor and
// issue O += P V of it (v_prev: its V); run this tile's softmax while that
// P V is on the tensor cores; wait for it and round this tile's P to bf16
// into p (the accumulator layout of one product is the A-fragment layout
// of the next). Afterwards this tile is pending with its factor in corr,
// and the previous tile's stage is free. PENDING is a template argument so
// that every wgmma issue and wait is unconditional, and callers branch only
// on values uniform over the block: ptxas serialises wgmma around waits it
// cannot match.
template <int KT, int HD, bool MASK, bool PENDING>
__device__ __forceinline__ void flash_step(
    float* s, float* o, uint32_t* p, float* m, float* l, float* corr,
    float sl2, int k0, const int* qpos, uint32_t q, uint32_t k,
    uint32_t v_prev) {
  qk_issue<KT, HD>(s, q, k);
  if constexpr (PENDING) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    pv_issue<KT, HD>(o, p, v_prev);
    wgmma_wait<1>();  // S has landed; P V may still run
  } else {
    wgmma_wait<0>();
  }
  fence_regs<KT / 2>(s);
  softmax_scores<KT, MASK>(s, m, l, corr, sl2, k0, qpos);
  if constexpr (PENDING) {
    wgmma_wait<0>();
    fence_regs<HD / 2>(o);
    fence_regs<KT / 4>(p);
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O = O * corr + P V of the pending tile, waited for.
template <int KT, int HD>
__device__ __forceinline__ void flash_drain(float* o, uint32_t* p,
                                            const float* corr,
                                            uint32_t v_prev) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
  pv_issue<KT, HD>(o, p, v_prev);
  wgmma_wait<0>();
  fence_regs<HD / 2>(o);
  fence_regs<KT / 4>(p);
}

// The warpgroup's output o * inv (inv per row) rounded once to bf16, staged
// in `stage` (HD/64 swizzled panels of 64 rows, the warpgroup's own) and
// written as 16-byte stores: row r to dst_row(r) (nullptr: not written),
// columns below hd. `bar` is the warpgroup's named barrier.
template <int HD, class RowPtr>
__device__ __forceinline__ void store_rows(const float* o, const float* inv,
                                           uint8_t* stage, int hd,
                                           RowPtr dst_row, int bar) {
  const int t = threadIdx.x & 127, w = t >> 5, g = (t & 31) >> 2;
  const int c2 = (t & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + g + 8 * h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + c2;
      uint8_t* a = stage + (col / 64) * 64 * PANEL_ROW +
                   sw128_off(r, (col % 64) / 8) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(a) =
          pack_bf16(o[4 * n + 2 * h] * inv[h], o[4 * n + 2 * h + 1] * inv[h]);
    }
  }
  named_sync(bar, 128);
  for (int e = t; e < 64 * (HD / 8); e += 128) {
    const int r = e / (HD / 8), ch = e % (HD / 8);
    if (ch * 8 >= hd) continue;
    bf16* dst = dst_row(r);
    if (dst == nullptr) continue;
    *reinterpret_cast<uint4*>(dst + ch * 8) = *reinterpret_cast<const uint4*>(
        stage + (ch / 8) * 64 * PANEL_ROW + sw128_off(r, ch % 8));
  }
}

}  // namespace sm90
