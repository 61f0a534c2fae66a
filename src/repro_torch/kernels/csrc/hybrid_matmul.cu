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
// Both bf16 kernels work on a row block's column union: a block of BM =
// 128 rows reads its slots' indices (one contiguous range) through shared
// memory with cp.async, all in flight at once, marks the valid slots'
// columns in a byte map of N (plain byte stores: every writer stores 1),
// folds it into a bitmap a thread a word and scans the words' popcounts
// over the block: the union's U columns in ascending order, and each
// column's position among them (block_union, union_columns). All on the
// card: the host never reads the pattern. Those maps take 5.25 bytes a
// column of N, which leaves no ring beside them past N ~19000. Past N
// 16384 (deepseek's d_ff 22016, llama3's 53248) the host plan takes the
// wide maps (the WIDE instantiations): only the bitmap and its prefix
// (0.25 bytes a column) and the union's columns, sized by the most a
// 128-row block can hold, min(N, 128 E) (16384 at E 128); the columns are
// ORed into the bitmap with shared-memory atomics, and a column's
// position is its word's prefix plus the popcount of the bits below it.
// Every plan up to N 16384 keeps the narrow maps.
//
// K8 in bf16 (h2d_union_kernel: W bf16, slot values bf16 or f32). What
// bounds it: at the training shape (M 8192, K 2048, N 5632, ELL width 128,
// ~108 valid slots a row over 216 live columns) writing the f32 (M, K)
// output, 67 MB, takes 20 us at 3.35 TB/s; the products over a 128-row
// block's union (~216 columns, padded to 256), 8192 x 256 x 2048 x 2 =
// 8.6 GFLOP, 9 us at the bf16 tensor-core peak. A kernel that takes one
// row at a time reads a 4 KB W row per valid slot (3.6 GB through L2 a
// call) on CUDA cores. The Pallas kernel scatters a row block's slots
// into (rows x 256-column) tiles in VMEM and runs them on the MXU; this
// kernel scatters them into one tile over the block's union:
//   * grid (row block, split s of S), two warpgroups a block. y's columns
//     are cut into K slices of KS = 128; block s takes slices s, s + S, ...
//     and loops over them, so the union and the h tile are built once a
//     block. S and the tile's width HC come from the host plan
//     (kernels/hybrid_matmul.py: h2d_plan, from shapes and the SM count);
//   * the h tile: each valid slot's value at (row, its column's position)
//     of a (BM x HC) bf16 tile, K-major, 128B-swizzled, every other entry
//     zero (slots past row_nnz, backup rows, rows past M, positions past
//     U). The slots' indices and values are copied through the drained
//     ring. A row's valid slots hold distinct columns (pack writes each of
//     a row's non-zeros once, in column order), so an entry gets at most
//     one write. f32 values (the backward's gradients) go in as two
//     tiles, bf16 hi = bf16(v) and lo = bf16(v - hi), over one W operand:
//     v - hi - lo is below 2^-18 |v|, and every product is exact in the
//     f32 accumulators;
//   * a K slice's products: per 64-deep stage of union positions, the
//     stage's 64 W rows gathered by index (cp.async in 16-byte pieces into
//     two 128B-swizzled panels of 64 y columns, zero past U and past K;
//     TMA has no gather) through a ring of stages, two fewer ahead than it
//     holds, running ahead across K slices; wgmma m64n128k16 with A = the
//     h tile (K-major, one warpgroup per 64 rows) and B = the W rows read
//     MN-major (the transpose bit), f32 accumulators, one wgmma group in
//     flight behind the next stage's copies;
//   * the epilogue: the accumulators hold two adjacent y columns of a row
//     in a thread, so each warp's store covers whole 32-byte sectors of
//     y's rows straight from the registers (streaming stores, no staging
//     in shared memory), issued while the next slice's copies land. Each y
//     element has one writer and a fixed summation order: no atomics, the
//     same bits every run. A block whose union is empty writes its zeros;
//   * a union wider than the tile (a pattern scattered over N) goes in
//     chunks of HC positions: for each K slice and chunk the ring drains,
//     the tile is scattered again and the chunk's stages run into the
//     same accumulators.
//
// K9 in bf16 (d2h_union_kernel). What bounds it: at the training shape
// reading x, 33.5 MB, is 10 us at 3.35 TB/s, and the products over the
// live columns, 8192 x 216 x 2048 x 2 = 7.2 GFLOP, are 7 us at the bf16
// tensor-core peak. A kernel that takes one row at a time reads a 4 KB Wt
// row per slot (3.6 GB through L2 a call) and does the dot products on
// CUDA cores. The Pallas kernel runs a dense (row block x N tile) product
// on the MXU and picks the pattern's entries; this kernel does the same
// with the columns no row of the block uses left out:
//   * grid (row block of BM rows, split s of S), two warpgroups a block;
//     the union built as above;
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
// In both, every branch around a wgmma depends only on values uniform over
// the block (U, K); the accumulators' zeroing is fenced off (fence_regs).
//
// In float32 (W f32: the float32 gradient checks) both stay per-row
// kernels on CUDA cores, which keep the products exact in f32 (bf16 wgmma
// cannot take f32 inputs exactly, and tf32 keeps too few bits for those
// checks). K8 (h2d_f32_kernel): grid (row, 1024-column slice of y); the
// block stages the row's slot values and indices in shared memory, then
// each thread keeps 8 f32 accumulators of y in registers and walks the
// slots in order with one 16-byte load of W's row per slot. K9
// (d2h_f32_kernel): grid (row); the block stages x's row in shared memory,
// each warp takes every fourth slot and forms the dot product with Wt's row
// by 16-byte loads and a shuffle reduction in f32.
#include <type_traits>

#include "sm90_common.cuh"

using namespace sm90;

namespace {

constexpr int H2D_THREADS = 128;           // the f32 K8 kernel's threads
constexpr int H2D_COLS = 8 * H2D_THREADS;  // and its y columns per block
constexpr int D2H_WARPS = 4;               // the f32 K9 kernel's warps
constexpr int MAX_E = 1024;                // ELL width the kernels take

constexpr int BM = 128;       // rows a block of the union kernels: two
constexpr int THREADS = 2 * BM;  // warpgroups of 64
constexpr int WARPS = THREADS / 32;

// K9's bf16 kernel
constexpr int UN = 128;                    // union columns a chunk: wgmma N
constexpr int BK = 64;                     // K of a ring stage: a panel row
constexpr int SROW = UN + 8;  // a staged accumulator row, in floats: the
                              // pad keeps the float2 stores conflict-free

struct D2h {
  static constexpr uint32_t A = BM * PANEL_ROW;        // x: BM rows x BK
  static constexpr uint32_t B = UN * PANEL_ROW;        // Wt: UN rows x BK
  static constexpr uint32_t STAGE = A + B;             // a stage of one chunk
  static constexpr int RSTEP = THREADS / 8;  // rows between a thread's pieces
  static constexpr int AJ = BM / RSTEP;      // a thread's pieces of x
  static constexpr int BJ = UN / RSTEP;      // a thread's pieces of Wt
};

// K8's bf16 kernel
constexpr int KS = 128;       // y columns a K slice: wgmma N
constexpr int US = 64;        // union positions a stage (a panel row)
struct H2d {
  static constexpr uint32_t PANEL = US * PANEL_ROW;    // 64 W rows x 64 y
  static constexpr uint32_t STAGE = 2 * PANEL;         // columns; a stage:
                                                       // the slice's 128
  static constexpr uint32_t HPANEL = BM * PANEL_ROW;   // h: BM rows x 64
};                                                     // positions

// the most columns a row block's union can hold: min(N, BM x E)
__host__ __device__ inline int union_cap(int N, int E) {
  return N < BM * E ? N : BM * E;
}

// shared memory of a row block's union at N columns. Narrow maps (every
// plan up to N 16384): the union's columns and each column's position
// (u16) [N] each, the bitmap and its prefix [NW] each, the byte map
// [32 NW], the rows' valid slot counts [BM] and U. Wide maps (where the
// narrow ones leave no room for a ring): the bitmap and its prefix [NW]
// each, the union's columns [union_cap] (u16, rounded up to even), the
// rows' counts [BM], U and the warps' totals: a column's position is its
// word's prefix plus the bits below it, and the columns are marked in the
// bitmap directly (shared-memory atomicOr), with no byte map
inline size_t union_bytes(int N, int E, bool wide) {
  const size_t nw = (N + 31) / 32;
  if (wide) return 8 * nw + 4 * (size_t)((union_cap(N, E) + 1) / 2) +
                   4 * BM + 48;
  return 4 * (size_t)N + 40 * nw + 4 * BM + 16;
}

// dynamic shared memory of d2h_union_kernel<nst> at N columns (the host
// plan computes the same): 1 KB of alignment slack, the ring (the staged
// accumulators are aliased over it), the union's maps
inline size_t d2h_smem(int nst, int N, int E, bool wide) {
  return 1024 + (size_t)nst * D2h::STAGE + union_bytes(N, E, wide);
}

// dynamic shared memory of h2d_union_kernel at N columns, a ring of nst
// stages and an h tile of hc positions in `terms` bf16 parts (1: bf16
// values, 2: f32 values as hi + lo): slack, ring, tiles, the union's maps
inline size_t h2d_smem(int nst, int hc, int terms, int N, int E, bool wide) {
  return 1024 + (size_t)nst * H2d::STAGE +
         (size_t)terms * (hc / US) * H2d::HPANEL + union_bytes(N, E, wide);
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

// ---- a row block's column union (K8 and K9) ------------------------------

// WIDE: the wide maps of union_bytes (no position table, no byte map)
template <bool WIDE>
struct UnionMaps {
  uint16_t* cols;     // [N] (wide: [union_cap]) the union's columns in
                      // ascending order
  uint16_t* pos;      // [N] each column's position among them (N < 65536);
                      // narrow only
  uint32_t* bits;     // [NW] bit b of word w: column 32 w + b is in it
  int* pre;           // [NW] the union's columns below word w
  uint32_t* flags32;  // [8 NW] the byte map of N, as words; narrow only
  int* nv;            // [BM] the rows' valid slots
  int* u_s;           // U
  int* tot;           // [WARPS] the scan's warp totals (narrow: over the
                      // byte map, read by then)

  __device__ UnionMaps(uint8_t* base, int N, int E) {
    const int nw = (N + 31) / 32;
    if constexpr (WIDE) {
      bits = reinterpret_cast<uint32_t*>(base);
      pre = reinterpret_cast<int*>(bits + nw);
      cols = reinterpret_cast<uint16_t*>(pre + nw);
      nv = reinterpret_cast<int*>(cols + 2 * ((union_cap(N, E) + 1) / 2));
      u_s = nv + BM;
      tot = u_s + 4;
      pos = nullptr;
      flags32 = nullptr;
    } else {
      cols = reinterpret_cast<uint16_t*>(base);
      pos = cols + N;
      bits = reinterpret_cast<uint32_t*>(pos + N);
      pre = reinterpret_cast<int*>(bits + nw);
      flags32 = reinterpret_cast<uint32_t*>(pre + nw);
      nv = reinterpret_cast<int*>(flags32 + 8 * nw);
      u_s = nv + BM;
      tot = reinterpret_cast<int*>(flags32);
    }
  }

  // the union position of column col (in the union): the table's entry,
  // or (wide) its word's prefix plus the bits below it
  __device__ __forceinline__ int position(int col) const {
    if constexpr (WIDE) {
      const int w = col >> 5;
      return pre[w] + __popc(bits[w] & ((1u << (col & 31)) - 1u));
    } else {
      return pos[col];
    }
  }
};

// The block's slots, rv rows of E from bidx (one contiguous range of idx),
// read through shared memory buf (cap ints) in pieces of whole rows, each
// piece copied with cp.async (every piece in flight at once, 16 bytes when
// vec: E % 4 == 0 and idx aligned), then fn(r, e, col) called for every
// slot of the piece: col is the index on a valid slot (e < nv[r]), -1 past
// the row's valid slots. Every thread of the block calls it.
template <typename F>
__device__ __forceinline__ void each_slot(const int* __restrict__ bidx,
                                          bool vec, int rv, int E,
                                          const int* nv, int* buf, int cap,
                                          F&& fn) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = cap / E;  // rows a piece (callers: a row of MAX_E fits)
  for (int r_lo = 0; r_lo < rv; r_lo += per) {
    const int cnt = min(per, rv - r_lo) * E;
    const int* src = bidx + (size_t)r_lo * E;
    if (vec)
      for (int i = 4 * tid; i < cnt; i += 4 * THREADS)
        cp_async16(smem_u32(buf + i), src + i, true);
    else
      for (int i = tid; i < cnt; i += THREADS)
        cp_async4(smem_u32(buf + i), src + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < min(per, rv - r_lo); r += WARPS) {
      const int n = nv[r_lo + r];
      for (int e0 = 0; e0 < E; e0 += 128) {  // 4 loads a lane, then 4 calls
        int col[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + lane + 32 * q;
          col[q] = e < n ? buf[r * E + e] : -1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (e0 + lane + 32 * q < E) fn(r_lo + r, e0 + lane + 32 * q, col[q]);
      }
    }
    __syncthreads();  // the piece is read before the next one lands
  }
}

// prefetch to L2 the 128-byte lines of bytes [p, p + n), thread t of
// `threads` taking lines t, t + threads, ...
__device__ __forceinline__ void prefetch_l2(const void* p, size_t n, int t,
                                            int threads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (uintptr_t q = (a & ~(uintptr_t)127) + 128 * t; q < a + n;
       q += 128 * threads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q));
}

// The union of the valid slots' columns of rows m0 .. m0 + rv - 1: their
// valid slot counts into u.nv (warps 0-3; warps 4-7 meanwhile prefetch the
// indices to L2 and call early(t) as thread t of 128), the columns marked
// in the byte map through buf (cap ints, at least one row of MAX_E),
// folded into u.bits a thread a word, u.pre the words' prefix popcount (a
// scan over the block). With the wide maps the columns are ORed into
// u.bits directly. other(r, e) is called for every slot that is not valid
// (past row_nnz, a backup row, an index outside [0, N)). Returns U. Every
// thread of the block calls it.
template <bool WIDE, typename F, typename G>
__device__ int block_union(const int* __restrict__ idx,
                           const int* __restrict__ row_nnz,
                           const uint8_t* __restrict__ sparse, int m0, int rv,
                           int E, int N, const UnionMaps<WIDE>& u, int* buf,
                           int cap, F&& other, G&& early) {
  static_assert(THREADS == 2 * BM, "a thread a row's count, then the rest");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NW = (N + 31) / 32;
  uint8_t* flags = reinterpret_cast<uint8_t*>(u.flags32);
  const int* bidx = idx + (size_t)m0 * E;
  const bool vec = E % 4 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  // the rows' valid slots; the indices on their way; the byte map cleared
  if (tid < BM) {
    u.nv[tid] = tid < rv ? valid_slots(row_nnz, sparse, m0 + tid, E) : 0;
  } else {
    prefetch_l2(bidx, (size_t)rv * E * 4, tid - BM, THREADS - BM);
    early(tid - BM);
  }
  if constexpr (WIDE) {
    for (int w = tid; w < NW; w += THREADS) u.bits[w] = 0u;
  } else {
    for (int w = tid; w < 8 * NW; w += THREADS) u.flags32[w] = 0u;
  }
  __syncthreads();
  each_slot(bidx, vec, rv, E, u.nv, buf, cap, [&](int r, int e, int col) {
    if ((unsigned)col < (unsigned)N) {
      if constexpr (WIDE)
        atomicOr(&u.bits[col >> 5], 1u << (col & 31));
      else
        flags[col] = 1;
    } else {
      other(r, e);
    }
  });
  // the bitmap (bit b of word w: column 32 w + b) from the byte map's 0/1
  // bytes, a thread taking a run of words, and their popcount
  const int per = (NW + THREADS - 1) / THREADS;
  const int lo = min(tid * per, NW), hi = min(lo + per, NW);
  int cnt = 0;
  for (int w = lo; w < hi; ++w) {
    uint32_t b = 0;
    if constexpr (WIDE) {
      b = u.bits[w];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t f = u.flags32[8 * w + q];  // columns 32 w + 4 q + 0..3
        b |= ((f & 1u) | ((f >> 7) & 2u) | ((f >> 14) & 4u) |
              ((f >> 21) & 8u))
             << (4 * q);
      }
      u.bits[w] = b;
    }
    cnt += __popc(b);
  }
  // the runs' exclusive prefix: a scan in each warp, then the warps' totals
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  int* tot = u.tot;  // [WARPS]
  __syncthreads();
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  int run = inc - cnt;
  for (int v = 0; v < warp; ++v) run += tot[v];
  for (int w = lo; w < hi; ++w) {
    u.pre[w] = run;
    run += __popc(u.bits[w]);
  }
  if (tid == THREADS - 1) *u.u_s = run;
  __syncthreads();
  return *u.u_s;
}

// the union's columns in ascending order into u.cols, and (narrow) each
// one's position into u.pos
template <bool WIDE>
__device__ void union_columns(const UnionMaps<WIDE>& u, int N) {
  const int NW = (N + 31) / 32;
  for (int w = threadIdx.x; w < NW; w += THREADS) {
    uint32_t b = u.bits[w];
    int p = u.pre[w];
    while (b) {
      const int col = 32 * w + __ffs(b) - 1;
      u.cols[p] = (uint16_t)col;
      if constexpr (!WIDE) u.pos[col] = (uint16_t)p;
      ++p;
      b &= b - 1;
    }
  }
  __syncthreads();
}

// ---- K8 ------------------------------------------------------------------

__global__ void __launch_bounds__(H2D_THREADS)
    h2d_f32_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   const int* __restrict__ row_nnz,
                   const uint8_t* __restrict__ sparse,
                   const float* __restrict__ w, float* __restrict__ y, int E,
                   int K) {
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

// cp.async of the 16-byte-aligned envelope of bytes [src, src + n) to
// shared address dst (src lands at dst + src % 16), every piece in flight
// at once. The envelope lies in the operand's allocation (a 16-byte
// aligned base; PyTorch allocates in whole 512-byte blocks).
__device__ __forceinline__ void copy_envelope(uint32_t dst, const void* src,
                                              size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~(uintptr_t)15, hi = (a + n + 15) & ~(uintptr_t)15;
  for (uintptr_t p = lo + 16 * threadIdx.x; p < hi; p += 16 * THREADS)
    cp_async16(dst + (uint32_t)(p - lo), reinterpret_cast<const void*>(p),
               true);
}

// a slot's value into the h tile at byte a: bf16 as it is; f32 as bf16 hi
// there and lo = bf16(v - hi) one tile further
__device__ __forceinline__ void put(uint8_t* a, bf16 v, uint32_t) {
  *reinterpret_cast<bf16*>(a) = v;
}

__device__ __forceinline__ void put(uint8_t* a, float v, uint32_t lo_off) {
  const bf16 hi = __float2bfloat16_rn(v);
  *reinterpret_cast<bf16*>(a) = hi;
  *reinterpret_cast<bf16*>(a + lo_off) =
      __float2bfloat16_rn(v - __bfloat162float(hi));
}

template <typename TV, int NST, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    h2d_union_kernel(const TV* __restrict__ vals, const int* __restrict__ idx,
                     const int* __restrict__ row_nnz,
                     const uint8_t* __restrict__ sparse,
                     const bf16* __restrict__ w, float* __restrict__ y, int M,
                     int E, int K, int N, int hc) {
  typedef H2d L;
  constexpr int TERMS = std::is_same<TV, float>::value ? 2 : 1;
  constexpr int AH = NST - 2;  // stages copied ahead of the one computed
  static_assert(AH >= 2, "the ring holds the stage in flight");
  extern __shared__ __align__(1024) uint8_t smem_h2d[];
  uint8_t* ring = smem_aligned(smem_h2d);          // [NST] stages
  uint8_t* tile = ring + NST * L::STAGE;           // [TERMS][hc / US] panels
  const uint32_t tile_bytes = (hc / US) * L::HPANEL;  // one term's tile
  const UnionMaps<WIDE> u(tile + TERMS * tile_bytes, N, E);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, s = blockIdx.y, S = gridDim.y;
  const int rv = min(BM, M - m0);  // the block's rows
  // the union, its indices read through the ring; meanwhile the slots'
  // values go to L2 and the tile is zeroed
  constexpr int VB = sizeof(TV);
  const int U = block_union(
      idx, row_nnz, sparse, m0, rv, E, N, u, reinterpret_cast<int*>(ring),
      NST * L::STAGE / 4, [](int, int) {}, [&](int t) {
        prefetch_l2(vals + (size_t)m0 * E, (size_t)rv * E * VB, t, BM);
        for (int i = t; i < (int)(TERMS * tile_bytes / 16); i += BM)
          reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
      });
  union_columns(u, N);
  const int ust = (U + US - 1) / US;     // stages over the union
  const int hcs = hc / US;               // stages a chunk of the tile
  const int nch = (ust + hcs - 1) / hcs;  // chunks (1: the tile stays)
  const bool resident = nch <= 1;
  const int mine = ((K + KS - 1) / KS - s + S - 1) / S;  // K slices
  const int total = mine * ust;          // stages of the block

  // a thread copies 16-byte piece ch of stage rows r0 and r0 + 32
  const int ch = tid % 8, r0 = tid / 8;
  const uint32_t ring_a = smem_u32(ring), tile_a = smem_u32(tile);
  // accumulator element 4j + 2h + e of this thread: row 16 wwarp + g8 + 8h
  // of its warpgroup's 64, y column 8j + c2 + e of the slice
  const int wg = tid / 128, wwarp = (tid % 128) / 32;
  const int g8 = lane / 4, c2 = (lane % 4) * 2;

  // stage j into ring slot j % NST: the W rows of union positions
  // 64 (j % ust) .. + 63, y columns of K slice s + S (j / ust); zero past U
  // and past K
  auto issue = [&](int jn) {
    const int k0 = (s + S * (jn / ust)) * KS, p0 = (jn % ust) * US;
    const uint32_t dst = ring_a + (jn % NST) * L::STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = r0 + 32 * i, p = p0 + pr;
      const int col = p < U ? u.cols[p] : -1;
#pragma unroll
      for (int pn = 0; pn < 2; ++pn) {
        const int k = k0 + pn * 64 + ch * 8;
        const bool ok = col >= 0 && k < K;
        cp_async16(dst + pn * L::PANEL + sw128_off(pr, ch),
                   w + (ok ? (size_t)col * K + k : 0), ok);
      }
    }
  };

  // the tile of chunk c (positions c hc .. c hc + hc - 1): zeroed (but
  // the first time: zeroed at the start), then each valid slot whose
  // position falls in it written at (row, position - c hc). The slots'
  // indices and values go through the drained ring in pieces of whole rows,
  // double-buffered: piece i + 1 is copied while piece i is written. A warp
  // takes two rows at a time, and a lane loads its 8 slots before it looks
  // up their positions and stores them.
  const uint32_t half = NST * L::STAGE / 2;  // a piece's buffer
  const int pieces = (rv - 1) / ((half - 128) / (E * (4 + VB))) + 1;
  const int per = (rv + pieces - 1) / pieces;  // rows a piece
  auto fetch = [&](int pc) {  // piece pc into buffer pc % 2
    const size_t first = (size_t)(m0 + pc * per) * E;
    const size_t cnt = (size_t)min(per, rv - pc * per) * E;
    const uint32_t buf = ring_a + (pc & 1) * half;
    copy_envelope(buf, idx + first, cnt * 4);
    copy_envelope(buf + ((cnt * 4 + 32 + 15) & ~(size_t)15), vals + first,
                  cnt * VB);
  };
  auto scatter = [&](int c, bool zero) {
    if (zero) {
      const int panels = min(hcs, ust - c * hcs);
      for (int t = 0; t < TERMS; ++t)
        for (int i = tid; i < panels * (int)(L::HPANEL / 16); i += THREADS)
          reinterpret_cast<uint4*>(tile + t * tile_bytes)[i] =
              make_uint4(0u, 0u, 0u, 0u);
    }
    fetch(0);
    cp_async_commit();
    for (int pc = 0; pc < pieces; ++pc) {
      if (pc + 1 < pieces) fetch(pc + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // piece pc landed; the zeros are written
      const int r_lo = pc * per, rows = min(per, rv - r_lo);
      const size_t first = (size_t)(m0 + r_lo) * E, cnt = (size_t)rows * E;
      uint8_t* buf = ring + (pc & 1) * half;
      const int* sidx = reinterpret_cast<const int*>(
          buf + ((uintptr_t)(idx + first) & 15));
      const TV* sval = reinterpret_cast<const TV*>(
          buf + ((cnt * 4 + 32 + 15) & ~(size_t)15) +
          ((uintptr_t)(vals + first) & 15));
      for (int ra = warp; ra < rows; ra += 2 * WARPS) {
        const int rr[2] = {ra, ra + WARPS};
        const int nn[2] = {u.nv[r_lo + ra],
                           ra + WARPS < rows ? u.nv[r_lo + ra + WARPS] : 0};
        for (int e0 = 0; e0 < max(nn[0], nn[1]); e0 += 128) {
          int cl[8];
          TV vl[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + lane + 32 * (i % 4);
            const bool ok = e < nn[i / 4];
            cl[i] = ok ? sidx[rr[i / 4] * E + e] : -1;
            vl[i] = ok ? sval[rr[i / 4] * E + e] : TV(0);
          }
          int off[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool in = (unsigned)cl[i] < (unsigned)N;
            const unsigned p =
                (unsigned)((in ? u.position(cl[i]) : 0) - c * hc);
            const int r = r_lo + rr[i / 4];
            // sw128_off(r, (p % 64) / 8) + (p % 8) * 2 in panel p / 64
            off[i] = in && p < (unsigned)hc
                         ? (int)((p / US) * L::HPANEL + r * PANEL_ROW +
                                 (((p % US) * 2) ^ ((r & 7) << 4)))
                         : -1;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (off[i] >= 0) put(tile + off[i], vl[i], tile_bytes);
        }
      }
      __syncthreads();  // buffer pc % 2 is read before piece pc + 2 lands
    }
  };

  int j = 0, seg_end = 0;  // the next stage computed; the copies' limit
  for (int ti = 0; ti < mine; ++ti) {
    const int k0 = (s + S * ti) * KS;
    float acc[KS / 2];
#pragma unroll
    for (int i = 0; i < KS / 2; ++i) acc[i] = 0.f;
    fence_regs<KS / 2>(acc);
    for (int c = 0; c < nch; ++c) {
      const int u0 = c * hcs, u1 = min(ust, u0 + hcs);
      wgmma_wait<0>();  // the tile's readers are done
      if (!resident || ti == 0) {  // uniform over the block
        cp_async_wait<0>();
        __syncthreads();  // the ring and the tile are free
        scatter(c, ti > 0 || c > 0);
        // resident: the copies run ahead over all the block's stages;
        // else over this chunk's
        seg_end = resident ? total : j + (u1 - u0);
#pragma unroll
        for (int a = 0; a < AH; ++a) {
          if (j + a < seg_end) issue(j + a);
          cp_async_commit();
        }
      }
      for (int uu = u0; uu < u1; ++uu, ++j) {
        cp_async_wait<AH - 1>();  // this thread's copies of stage j landed
        fence_proxy_async();
        // every thread's copies (and tile writes) landed; the wgmmas of
        // stage j - 2, the slot the next copies go to, are complete in
        // both warpgroups
        __syncthreads();
        if (j + AH < seg_end) issue(j + AH);
        cp_async_commit();
        const uint32_t b_s = ring_a + (j % NST) * L::STAGE;
        const uint32_t a_s =
            tile_a + (uu - u0) * L::HPANEL + wg * 64 * PANEL_ROW;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < US / 16; ++kk)
#pragma unroll
          for (int t = 0; t < TERMS; ++t)
            WgmmaTB<KS>::mma(acc, sw128_desc(a_s + t * tile_bytes + kk * 32, 0),
                             sw128_desc(b_s + kk * 16 * PANEL_ROW, L::PANEL));
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    fence_regs<KS / 2>(acc);
    // y's rows of this slice: two adjacent columns a thread, whole 32-byte
    // sectors a warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + 16 * wwarp + g8 + 8 * h;
      if (row < M) {
        float* dst = y + (size_t)row * K + k0 + c2;
#pragma unroll
        for (int jj = 0; jj < KS / 8; ++jj)
          if (k0 + 8 * jj < K)
            __stcs(reinterpret_cast<float2*>(dst + 8 * jj),
                   make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]));
      }
    }
  }
}

// ---- K9 ------------------------------------------------------------------

template <int NST, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    d2h_union_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     const int* __restrict__ idx,
                     const int* __restrict__ row_nnz,
                     const uint8_t* __restrict__ sparse,
                     float* __restrict__ vals, int M, int E, int K, int N) {
  typedef D2h L;
  extern __shared__ __align__(1024) uint8_t smem_d2h[];
  uint8_t* ring = smem_aligned(smem_d2h);               // [NST] stages
  const UnionMaps<WIDE> u(ring + NST * L::STAGE, N, E);
  float* stg = reinterpret_cast<float*>(ring);  // [P][BM][SROW] after a pass

  const int tid = threadIdx.x, lane = tid % 32;
  const int m0 = blockIdx.x * BM, s = blockIdx.y, S = gridDim.y;
  const int rv = min(BM, M - m0);  // the block's rows
  const int* bidx = idx + (size_t)m0 * E;
  const bool vec = E % 4 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  // the union, its indices read through the ring (free: pieces of the
  // whole ring); split 0 zeroes every slot that is not valid
  const int U = block_union(
      idx, row_nnz, sparse, m0, rv, E, N, u, reinterpret_cast<int*>(ring),
      NST * L::STAGE / 4,
      [&](int r, int e) {
        if (s == 0) vals[(size_t)(m0 + r) * E + e] = 0.f;
      },
      [](int) {});
  const int chunks = (U + UN - 1) / UN;
  if (s >= chunks) return;  // uniform over the block
  union_columns(u, N);

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
        colr[q][j] = p < min(lo + UN, U) ? u.cols[p] : -1;
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
    each_slot(bidx, vec, rv, E, u.nv,
              reinterpret_cast<int*>(stg + P * BM * SROW),
              (NST * L::STAGE - P * BM * SROW * 4) / 4,
              [&](int r, int e, int col) {
                if ((unsigned)col >= (unsigned)N) return;
                const int p = u.position(col);
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

template <typename TV, int NST, bool WIDE>
int launch_h2d(const void* vals, const void* idx, const void* row_nnz,
               const void* sparse, const void* w, void* y, int M, int E,
               int K, int N, int splits, int hc, size_t smem,
               cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      h2d_union_kernel<TV, NST, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  h2d_union_kernel<TV, NST, WIDE>
      <<<dim3((M + BM - 1) / BM, splits), THREADS, smem, st>>>(
          (const TV*)vals, (const int*)idx, (const int*)row_nnz,
          (const uint8_t*)sparse, (const bf16*)w, (float*)y, M, E, K, N, hc);
  return (int)cudaGetLastError();
}

template <int NST, bool WIDE>
int launch_union(const void* x, const void* wt, const void* idx,
                 const void* row_nnz, const void* sparse, void* vals, int M,
                 int E, int K, int N, int splits, size_t smem,
                 cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      d2h_union_kernel<NST, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  d2h_union_kernel<NST, WIDE>
      <<<dim3((M + BM - 1) / BM, splits), THREADS, smem, st>>>(
          (const bf16*)x, (const bf16*)wt, (const int*)idx,
          (const int*)row_nnz, (const uint8_t*)sparse, (float*)vals, M, E, K,
          N);
  return (int)cudaGetLastError();
}

}  // namespace

// vals (M, E) bf16 (vals_bf16 != 0) or f32, idx (M, E) int32, row_nnz (M,)
// int32, sparse (M,) uint8 (bool), w (N, K) bf16 (w_bf16 != 0) or f32 ->
// y (M, K) f32. Requires K % 8 == 0 and E <= 1024. bf16 w: the plan's
// splits S, ring depth (4-6), tile width hc (a multiple of 64), union maps
// (wide != 0: the wide ones) and dynamic shared memory (at least
// h2d_smem). f32 w takes f32 values and ignores the plan.
extern "C" int hybrid_to_dense(const void* vals, const void* idx,
                               const void* row_nnz, const void* sparse,
                               const void* w, void* y, int M, int E, int K,
                               int N, int w_bf16, int vals_bf16, int splits,
                               int stages, int hc, int wide, int smem,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!w_bf16) {
    if (vals_bf16) return (int)cudaErrorInvalidValue;
    h2d_f32_kernel<<<dim3(M, (K + H2D_COLS - 1) / H2D_COLS), H2D_THREADS, 0,
                     s>>>((const float*)vals, (const int*)idx,
                          (const int*)row_nnz, (const uint8_t*)sparse,
                          (const float*)w, (float*)y, E, K);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || N < 1 || N > 65535 || E < 1 || hc < US || hc % US ||
      smem < 0 ||
      (size_t)smem < h2d_smem(stages, hc, vals_bf16 ? 1 : 2, N, E, wide))
    return (int)cudaErrorInvalidValue;
#define H2D_UNION(NST_, WIDE_)                                               \
  if (stages == NST_ && (wide != 0) == WIDE_)                                \
    return vals_bf16 ? launch_h2d<bf16, NST_, WIDE_>(vals, idx, row_nnz,     \
                                                     sparse, w, y, M, E, K,  \
                                                     N, splits, hc, smem, s) \
                     : launch_h2d<float, NST_, WIDE_>(                       \
                           vals, idx, row_nnz, sparse, w, y, M, E, K, N,     \
                           splits, hc, smem, s);
  H2D_UNION(4, false)
  H2D_UNION(5, false)
  H2D_UNION(6, false)
  H2D_UNION(4, true)
  H2D_UNION(5, true)
  H2D_UNION(6, true)
#undef H2D_UNION
  return (int)cudaErrorInvalidValue;
}

// x (M, K), wt (N, K) both bf16 (bf16_in != 0) or both f32; idx (M, E)
// int32, row_nnz (M,) int32, sparse (M,) uint8 -> vals (M, E) f32.
// Requires K % 8 == 0. bf16: the plan's splits S, ring depth (4-6), union
// maps (wide != 0: the wide ones) and dynamic shared memory (at least
// d2h_smem); float32 ignores them.
extern "C" int dense_to_hybrid(const void* x, const void* wt, const void* idx,
                               const void* row_nnz, const void* sparse,
                               void* vals, int M, int E, int K, int N,
                               int bf16_in, int splits, int stages, int wide,
                               int smem, void* stream) {
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
  if (splits < 1 || N < 1 || N > 65535 || E < 1 || smem < 0 ||
      (size_t)smem < d2h_smem(stages, N, E, wide))
    return (int)cudaErrorInvalidValue;
#define D2H_UNION(NST_, WIDE_)                                          \
  if (stages == NST_ && (wide != 0) == WIDE_)                           \
    return launch_union<NST_, WIDE_>(x, wt, idx, row_nnz, sparse, vals, \
                                     M, E, K, N, splits, smem, s);
  D2H_UNION(4, false)
  D2H_UNION(5, false)
  D2H_UNION(6, false)
  D2H_UNION(4, true)
  D2H_UNION(5, true)
  D2H_UNION(6, true)
#undef D2H_UNION
  return (int)cudaErrorInvalidValue;
}
