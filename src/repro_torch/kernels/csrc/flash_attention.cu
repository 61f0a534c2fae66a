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
// peak (989 TFLOP/s), which only wgmma reaches. Both bounds are near, so
// the products run on wgmma fed by TMA, and each K/V row is read from
// device memory once per 128-row query tile.
//
// Design (bf16; the core is attention_sm90.cuh, shared with K4):
//   * a work item is 128 query rows of one (batch, head); a block has two
//     consumer warpgroups of 64 rows and a producer warpgroup (384
//     threads), whose one working thread issues the copies. setmaxnreg
//     moves registers from the producer (40) to the consumers (232),
//     which hold S, O and P at once. The grid is persistent, one block an
//     SM (at most the items), and block i takes items i, i + grid, ... of
//     a heaviest-first order (query tile reversed, then batch x head):
//     every round of items has one weight, every block starts with its
//     heaviest item and the light ones fill the tail. (An order by chunks
//     of heads, to keep the running items' K/V in L2, measured 26% slower:
//     the rounds' weights mix);
//   * the producer loads each item's Q into one of two slots and its K and
//     V tiles of KT keys into a ring of NST stages, all with TMA, with full
//     and empty mbarriers; the ring runs on across items, so the next
//     item's loads overlap this one's last tiles and epilogue. The tensor
//     maps are 4-D over the (B, S, H, hd) layout, {hd, H, S, B} with box
//     {64, 1, rows, 1} and the 128-byte swizzle: no host-side copy, and
//     reads past hd or past S are zero-filled by the hardware (hd 16..56
//     pad to one 64-column panel, hd 128 is two);
//   * both consumer warpgroups walk the key tiles up to the item's last
//     row: S = Q K^T and O += P V on wgmma (P from registers, V read
//     MN-major), the f32 online softmax in base 2 with scale * log2 e
//     folded in, software-pipelined (flash_step: a tile's Q K^T is issued
//     with the previous tile's P V, and the softmax runs while that P V is
//     on the tensor cores); only the tile(s) crossing the
//     item's diagonal are masked; P enters the second product rounded to
//     bf16 (the Pallas body's p.astype(v.dtype)) while l sums the f32
//     probabilities;
//   * output acc / max(l, 1e-30) rounded once to bf16, staged in the
//     warpgroup's Q slot and written as 16-byte stores; then the slot is
//     released to the producer.
// KT = 128 keys for hd <= 64, 64 for hd 128 (the S and O accumulators stay
// within the registers); the host plan (kernels/attention_plan.py) picks
// both and the grid, and flash_attention_bf16 launches only the pairs
// built here. At hd 128 ptxas still serialises the wgmmas (C7511, too few
// registers for the pipeline); that shape is off the training path.
// float32 inputs take a second, plain CUDA-core kernel (a warp per query
// row, 32-key tiles, f32 throughout): tensor-core TF32 would not hold the
// float32 tolerance; that path serves the tests, not the bf16 model.
// No atomics: each result is the same from run to run.
#include "attention_sm90.cuh"

using namespace sm90;

namespace {

constexpr int RT = 128;   // query rows of a work item (two warpgroups)
constexpr int NST = 4;    // K/V stages in the ring
constexpr int THREADS = 3 * 128;  // two consumer warpgroups, a producer one

template <int HD, int KT>
struct Layout {
  static constexpr uint32_t Q = (HD / 64) * 64 * PANEL_ROW;   // a warpgroup's Q
  static constexpr uint32_t KV = (HD / 64) * KT * PANEL_ROW;  // a K or V tile
  static constexpr uint32_t RING = 2 * 2 * Q;                 // after 2 Q slots
  static constexpr uint32_t BARS = RING + NST * 2 * KV;       // after the tiles
  static constexpr size_t SMEM = 1024 + BARS + 8 * (2 * NST + 4);
};

// the query tile and (batch x head) of work item w: heaviest tiles first
__device__ __forceinline__ void work_item(int w, int n_bh, int nqt, int& qt,
                                          int& bh) {
  qt = nqt - 1 - w / n_bh;
  bh = w % n_bh;
}

// The two consumer warpgroups: warpgroup wg takes rows q0 + 64 wg .. + 63
// of each of the block's items.
template <int HD, int KT>
__device__ __forceinline__ void consumer(bf16* __restrict__ out, int S,
                                         int H, int hd, float sl2, int n_bh,
                                         int nqt, uint8_t* sm) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  typedef Layout<HD, KT> L;
  const uint32_t s0 = smem_u32(sm);
  const uint32_t full = s0 + L::BARS, empty = full + 8 * NST,
                 qfull = empty + 8 * NST, qempty = qfull + 16;
  auto q_slot = [&](int slot) { return s0 + slot * 2 * L::Q; };
  auto k_tile = [&](int st) { return s0 + L::RING + st * 2 * L::KV; };
  const int total = n_bh * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows r0, r0 + 8
  const size_t rs = (size_t)H * hd;           // one position's stride
  int it = 0;
  for (int w = blockIdx.x, i = 0; w < total; w += gridDim.x, ++i) {
    int qt, bh;
    work_item(w, n_bh, nqt, qt, bh);
    const int b = bh / H, h = bh % H;
    const int q0 = qt * RT, q0w = q0 + 64 * wg;
    const int ntiles = (min(S, q0 + RT) + KT - 1) / KT;
    const int qpos[2] = {q0w + r0, q0w + r0 + 8};
    const int slot = i & 1;
    const uint32_t q = q_slot(slot) + wg * L::Q;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float o[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;

    mbar_wait(qfull + 8 * slot, (i >> 1) & 1);
    // Every branch below is uniform over the block (tile counters, the
    // item's q0), so ptxas keeps the wgmmas asynchronous. A key tile is
    // masked when it crosses the block's diagonal; at hd 128 (64-key tiles)
    // warpgroup 0's last tile lies wholly in its future and is masked whole.
    // The first tile is peeled: no P V is pending before it.
    float sc[KT / 2], corr[2];
    uint32_t pf[KT / 4];
    int st = it % NST;
    mbar_wait(full + 8 * st, (it / NST) & 1);
    if (KT - 1 > q0)
      flash_step<KT, HD, true, false>(sc, o, pf, m, l, corr, sl2, 0,
                                                qpos, q, k_tile(st), 0);
    else
      flash_step<KT, HD, false, false>(sc, o, pf, m, l, corr, sl2,
                                                 0, qpos, q, k_tile(st), 0);
    ++it;
    for (int t = 1; t < ntiles; ++t, ++it) {
      const int prev = st, k0 = t * KT;
      st = it % NST;
      mbar_wait(full + 8 * st, (it / NST) & 1);
      const uint32_t v_prev = k_tile(prev) + L::KV;
      if (k0 + KT - 1 > q0)
        flash_step<KT, HD, true, true>(sc, o, pf, m, l, corr, sl2,
                                                 k0, qpos, q, k_tile(st),
                                                 v_prev);
      else
        flash_step<KT, HD, false, true>(sc, o, pf, m, l, corr, sl2,
                                                  k0, qpos, q, k_tile(st),
                                                  v_prev);
      mbar_arrive_if(empty + 8 * prev, lane == 0);
    }
    flash_drain<KT, HD>(o, pf, corr, k_tile(st) + L::KV);
    mbar_arrive_if(empty + 8 * st, lane == 0);

    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                          1.f / fmaxf(l[1], 1e-30f)};
    bf16* base = out + (size_t)b * S * rs + (size_t)h * hd;
    store_rows<HD>(o, inv, sm + (q - s0), hd,
                   [&](int r) -> bf16* {
                     const int row = q0w + r;
                     return row < S ? base + (size_t)row * rs : nullptr;
                   },
                   1 + wg);
    fence_proxy_async();  // the staging writes before TMA refills the slot
    __syncwarp();
    mbar_arrive_if(qempty + 8 * slot, lane == 0);
  }
}

template <int HD, int KT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ out, int S, int H, int hd,
                       float sl2, int n_bh, int nqt) {
  typedef Layout<HD, KT> L;
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  uint8_t* sm = smem_aligned(smem_tiles);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t full = s0 + L::BARS, empty = full + 8 * NST,
                 qfull = empty + 8 * NST, qempty = qfull + 16;
  auto q_slot = [&](int slot) { return s0 + slot * 2 * L::Q; };
  auto k_tile = [&](int st) { return s0 + L::RING + st * 2 * L::KV; };
  const int total = n_bh * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block walks work items blockIdx.x, + gridDim.x, ...: Q of item i
  // goes to slot i % 2, its K/V tiles continue one ring across items, so
  // the next item's loads overlap this item's last tiles and epilogue.
  if (warp >= 8) {  // the producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;  // K/V tiles issued so far
      for (int w = blockIdx.x, i = 0; w < total; w += gridDim.x, ++i) {
        int qt, bh;
        work_item(w, n_bh, nqt, qt, bh);
        const int b = bh / H, h = bh % H, q0 = qt * RT;
        const int slot = i & 1;
        if (i >= 2) mbar_wait(qempty + 8 * slot, ((i >> 1) - 1) & 1);
        mbar_expect_tx(qfull + 8 * slot, 2 * L::Q);
        for (int g = 0; g < 2; ++g)
          for (int p = 0; p < HD / 64; ++p)
            tma_load_4d(q_slot(slot) + g * L::Q + p * 64 * PANEL_ROW, &tq,
                        p * 64, h, q0 + 64 * g, b, qfull + 8 * slot);
        const int ntiles = (min(S, q0 + RT) + KT - 1) / KT;
        for (int t = 0; t < ntiles; ++t, ++it) {
          const int st = it % NST;
          if (it >= NST) mbar_wait(empty + 8 * st, (it / NST - 1) & 1);
          mbar_expect_tx(full + 8 * st, 2 * L::KV);
          for (int p = 0; p < HD / 64; ++p) {
            const uint32_t off = p * KT * PANEL_ROW;
            tma_load_4d(k_tile(st) + off, &tk, p * 64, h, t * KT, b,
                        full + 8 * st);
            tma_load_4d(k_tile(st) + L::KV + off, &tv, p * 64, h, t * KT, b,
                        full + 8 * st);
          }
        }
      }
    }
  } else {
    consumer<HD, KT>(out, S, H, hd, sl2, n_bh, nqt, sm);
  }
}

// a (B, S, H, hd) bf16 tensor as {hd, H, S, B}, box {64, 1, rows, 1},
// 128-byte swizzle, zero fill out of bounds
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
             int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD, int KT>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int hd, float scale, int grid,
                cudaStream_t stream) {
  typedef Layout<HD, KT> L;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B, S, H, hd, 64);
  if (!e) e = make_map(&tk, k, B, S, H, hd, KT);
  if (!e) e = make_map(&tv, v, B, S, H, hd, KT);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const int nqt = (S + RT - 1) / RT;
  flash_wgmma_kernel<HD, KT><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, S, H, hd, scale * LOG2E, B * H, nqt);
  return (int)cudaGetLastError();
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

}  // namespace

// q, k, v, out (B, S, H, hd) bf16, 16-byte aligned; requires hd % 8 == 0
// and hd <= 128. hd_pad, key_tile and grid (persistent blocks) are the host
// plan's (attention_plan.flash_plan): (64, 128) for hd <= 64, (128, 64)
// above; 1 <= grid <= the query tiles of all heads.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int hd, float scale, int hd_pad,
                                    int key_tile, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (grid < 1 || grid > B * H * ((S + RT - 1) / RT))
    return (int)cudaErrorInvalidValue;
  if (hd_pad == 64 && key_tile == 128 && hd <= 64)
    return launch_bf16<64, 128>(q, k, v, out, B, S, H, hd, scale, grid, s);
  if (hd_pad == 128 && key_tile == 64 && hd <= 128)
    return launch_bf16<128, 64>(q, k, v, out, B, S, H, hd, scale, grid, s);
  return (int)cudaErrorInvalidValue;
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
