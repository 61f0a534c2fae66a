// The column union of a row block of the TwELL packed layout, built on the
// card: shared by K2 (twell_fused_ffn.cu) and K6 (twell_down_proj.cu).
//
// The packed layout: row m holds N/T tiles of tc = T/C slots; slot s of
// tile t (values and indices at m * slots + t * tc + s) is valid iff s <
// nnz[m, t] (nnz clipped to [0, tc]). The union of a block's rows is every
// column a valid slot names. It is built in three steps:
//   1. mark_prefixes: each (row, tile) pair's count read in the same round
//      as its first 8 slot indices (one 32-byte sector; later slots only up
//      to the count), 4 pairs a thread in flight, each valid column marked
//      in a byte map of N (every writer stores 1; no atomics);
//   2. TWELL_UNION_BUILD: the byte map's 0/1 bytes folded into a bitmap
//      (bit b of word w: column 32 w + b), a thread a run of words; with
//      `split` each rank of the cluster has marked only its share of the
//      rows, and the ranks OR their bitmaps through distributed shared
//      memory (DSMEM) after a cluster barrier; then an exclusive prefix
//      popcount of the words scanned over the block (a scan in each warp,
//      then the warps' totals): the union's U columns in ascending order
//      as u16;
//   3. `position`: any column's position in the union, its word's prefix
//      plus the bits below it.
// The host never reads the pattern.
#pragma once
#include "sm90_common.cuh"

namespace twell_union {

constexpr int MAX_KS = 8;  // portable cluster size

// bytes of the byte map of N (a word of 32 columns as 8 u32), staged over
// the caller's cp.async ring before the ring starts
__host__ __device__ inline uint32_t staging_bytes(int n) {
  return 32 * ((n + 31) / 32);
}

// clears the byte map of N (32 nwd bytes at `flags32`)
template <int THREADS>
__device__ __forceinline__ void clear_flags(uint32_t* flags32, int nwd) {
  for (int w = threadIdx.x; w < 8 * nwd; w += THREADS) flags32[w] = 0u;
}

// Marks in the byte map `flags` the columns of the valid prefixes of the
// block's (row, tile) pairs [p_lo, p_lo + count) (pair q = row x N/T +
// tile: its count at nnz_blk[q], its slots from idx_blk[q tc] on), 4 pairs
// a thread and 8 slots a pair in flight. idx_blk and nnz_blk point at the
// block's first row.
template <int THREADS>
__device__ __forceinline__ void mark_prefixes(uint8_t* flags,
                                              const int* __restrict__ idx_blk,
                                              const int* __restrict__ nnz_blk,
                                              int p_lo, int count, int tc,
                                              int N) {
  for (int p0 = threadIdx.x; p0 < count; p0 += 4 * THREADS) {
    int cnt[4], col[4][8];
    size_t base[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = p0 + a * THREADS, q = p_lo + p;
      const bool ok = p < count;
      cnt[a] = ok ? min(max(nnz_blk[q], 0), tc) : 0;
      base[a] = (size_t)q * tc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        col[a][j] = ok && j < tc ? idx_blk[base[a] + j] : -1;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < cnt[a] && (unsigned)col[a][j] < (unsigned)N)
          flags[col[a][j]] = 1;
    const int most = max(max(cnt[0], cnt[1]), max(cnt[2], cnt[3]));
    for (int j0 = 8; j0 < most; j0 += 8) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          col[a][j] = j0 + j < cnt[a] ? idx_blk[base[a] + j0 + j] : -1;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if ((unsigned)col[a][j] < (unsigned)N) flags[col[a][j]] = 1;
    }
  }
}

// the union position of column `col` (in the union)
__device__ __forceinline__ int position(const int* pre, const uint32_t* bits,
                                        int col) {
  const int w = col >> 5;
  return pre[w] + __popc(bits[w] & ((1u << (col & 31)) - 1u));
}

}  // namespace twell_union

// Steps 2 and 3, once every thread's marks are in the byte map `flags32`
// (a barrier before): declares `const int U`, the union's size, and fills
// the bitmap `bits` (with `split`: each rank's own in `lbits`, ORed over
// the cluster's `ks` ranks after a cluster barrier), the words' exclusive
// prefix popcount `pre` (`tot`: the warps' totals, `u_s`: U) and the
// columns `cols` (written by other threads: a barrier before they are
// read). Every rank calls it with `split`; the caller keeps its shared
// memory alive until the other ranks have read its bitmap. A macro over
// the caller's names, not a function: as a function (inlined or not, by
// pointers or by offsets) the same text compiled K2 to ~30 more registers
// and a kernel 2-4% slower at 20 and 256 rows on the H100 (sm_90a, CUDA
// 12.8); expanded in place it compiles as the code it came from.
#define TWELL_UNION_BUILD(U, THREADS, cluster, ks, split, flags32, bits,      \
                          lbits, pre, cols, u_s, tot, nwd, tid, warp, lane)   \
  const int tu_per = (nwd + THREADS - 1) / THREADS;                          \
  const int tu_lo = min(tid * tu_per, nwd);                                  \
  const int tu_hi = min(tu_lo + tu_per, nwd);                                \
  uint32_t* tu_fold = split ? lbits : bits;                                  \
  for (int w = tu_lo; w < tu_hi; ++w) {                                      \
    uint32_t b = 0;                                                          \
    _Pragma("unroll") for (int q = 0; q < 8; ++q) {                          \
      const uint32_t f = flags32[8 * w + q];                                 \
      b |= ((f & 1u) | ((f >> 7) & 2u) | ((f >> 14) & 4u) |                  \
            ((f >> 21) & 8u))                                                \
           << (4 * q);                                                       \
    }                                                                        \
    tu_fold[w] = b;                                                          \
  }                                                                          \
  if (split) {                                                               \
    cluster.sync();                                                          \
    for (int w = tu_lo; w < tu_hi; ++w) {                                    \
      uint32_t v[twell_union::MAX_KS];                                       \
      _Pragma("unroll") for (int rk = 0; rk < twell_union::MAX_KS; ++rk)     \
          v[rk] = cluster.map_shared_rank(lbits, rk < ks ? rk : 0)[w];       \
      uint32_t b = 0;                                                        \
      _Pragma("unroll") for (int rk = 0; rk < twell_union::MAX_KS; ++rk) b |= \
          v[rk];                                                             \
      bits[w] = b;                                                           \
    }                                                                        \
  }                                                                          \
  {                                                                          \
    int cnt = 0;                                                             \
    for (int w = tu_lo; w < tu_hi; ++w) cnt += __popc(bits[w]);              \
    int inc = cnt;                                                           \
    _Pragma("unroll") for (int o = 1; o < 32; o <<= 1) {                     \
      const int t = __shfl_up_sync(0xffffffffu, inc, o);                     \
      if (lane >= o) inc += t;                                               \
    }                                                                        \
    if (lane == 31) tot[warp] = inc;                                         \
    __syncthreads();                                                         \
    int run = inc - cnt;                                                     \
    for (int v = 0; v < warp; ++v) run += tot[v];                            \
    for (int w = tu_lo; w < tu_hi; ++w) {                                    \
      pre[w] = run;                                                          \
      run += __popc(bits[w]);                                                \
    }                                                                        \
    if (tid == THREADS - 1) *u_s = run;                                      \
  }                                                                          \
  __syncthreads();                                                           \
  const int U = *u_s;                                                        \
  for (int w = tid; w < nwd; w += THREADS) {                                 \
    uint32_t b = bits[w];                                                    \
    int p = pre[w];                                                          \
    while (b) {                                                              \
      cols[p++] = (uint16_t)(32 * w + __ffs(b) - 1);                         \
      b &= b - 1;                                                            \
    }                                                                        \
  }
