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
// provided they run on the tensor cores. So the work must be spread over
// enough SMs that the pages stream at the memory rate, not at one block's
// latency.
//
// Design (the core is attention_sm90.cuh, shared with K7):
//   * rows: the G*S rows of one (request, kv head): row j is head group
//     g = j / S, chunk offset i = j % S (head h = hkv*G + g), query position
//     seq_len + i -- GQA without repeat_kv, as the Pallas kernel lays its
//     rows out. A block takes 64 rows (one warpgroup) when G*S <= 64, else
//     128 (two), with further row tiles in the grid; Q is copied once into
//     128B-swizzled panels;
//   * keys: the live keys of a row tile (up to the last one any of its rows
//     can see) are split, in 64-key tiles, over the CL blocks of a thread-
//     block cluster. Each block stages its tiles through a ring of NST
//     stages: every thread copies 16-byte pieces of key rows, page by page
//     through the block table cached in shared memory, with cp.async into
//     the 128B-swizzled layout wgmma reads (zero-filled past the live keys
//     and past hd), one cp.async group per tile, two tiles ahead. cp.async and not TMA: a
//     tile gathers 64 / bs pages (bs 2..64 in the sweeps), and per-page
//     TMA boxes would need one tensor map per block size and as many
//     copies; the threads' copies take any bs;
//   * S = Q K^T and O += P V on wgmma (P from registers, V read MN-major),
//     the f32 online softmax in base 2 on the accumulators, P rounded to
//     bf16 for the second product, as the reference casts its probabilities
//     to the query dtype;
//   * merge: each block keeps its own (m, l, acc); after a cluster barrier
//     rank 0 reads the others' partials through distributed shared memory
//     in rank order, merges them and writes acc / max(l, 1e-30) rounded
//     once to bf16 -- deterministic, no second launch, no atomics. A split
//     with no live key holds m = -1e30, l = 0, acc = 0, so a row with no
//     live key at all (num_new = 0 and an empty history: a padded batch
//     row) is exactly zero.
// CL comes from the host plan (kernels/attention_plan.py: the block-table
// width x bs, never seq_lens), and so do the rows per block; the C entry
// point launches the head-dim template hd <= 64 -> 64 and else 128 (hd 16,
// 32, 48 are zero-padded to one 64-column panel).
#include <cooperative_groups.h>

#include "attention_sm90.cuh"

namespace cg = cooperative_groups;
using namespace sm90;

namespace {

constexpr int KT = 64;    // keys per tile
constexpr int NST = 4;    // stages in the ring
constexpr int AHEAD = 2;  // tiles in flight ahead of the one computed
constexpr int MAX_CL = 8;

template <int HD>
struct Layout {
  static constexpr uint32_t Q = (HD / 64) * 64 * PANEL_ROW;   // a warpgroup's Q
  static constexpr uint32_t KV = (HD / 64) * KT * PANEL_ROW;  // a K or V tile
  // partial acc of 128 rows (f32) reuses the stages after the key loop
  static_assert(128 * HD * 4 <= NST * 2 * KV, "partials fit the stages");
  static size_t smem(int nwg, int width) {
    return 1024 + nwg * Q + NST * 2 * KV + 2 * 128 * sizeof(float) +
           sizeof(int) * width;
  }
};

// hd 64: at most 128 registers, so two 256-thread blocks share an SM
template <int HD>
__global__ void __launch_bounds__(256, HD == 64 ? 2 : 1)
    chunk_wgmma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ kpool,
                       const bf16* __restrict__ vpool,
                       const int* __restrict__ bt,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ num_new, bf16* __restrict__ out,
                       int S, int hkv, int G, int hd, int bs, int width,
                       float sl2, int cl) {
  typedef Layout<HD> L;
  constexpr int CH = HD / 8;  // 16-byte chunks of a padded row
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  uint8_t* sm = smem_aligned(smem_tiles);
  const int nwg = blockDim.x / 128;
  uint8_t* q_s = sm;                                   // [nwg] Q panels
  uint8_t* kv_s = sm + nwg * L::Q;                     // [NST] K, V tiles
  float* m_s = reinterpret_cast<float*>(kv_s + NST * 2 * L::KV);  // [128]
  float* l_s = m_s + 128;                                         // [128]
  int* bt_s = reinterpret_cast<int*>(l_s + 128);                  // [width]
  float* part = reinterpret_cast<float*>(kv_s);  // [128][HD], after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % cl;
  const int rows = 64 * nwg;
  const int j0 = (blockIdx.x / cl) * rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(rows, G * S - j0);
  const int H = hkv * G;
  const int tid = threadIdx.x;
  const int sl = seq_lens[b];
  const int last = sl + num_new[b] - 1;  // < sl when num_new == 0

  // the last key any row of this tile can see, and this block's key tiles
  const int max_i = (j0 / S == (j0 + nrows - 1) / S) ? (j0 + nrows - 1) % S
                                                      : S - 1;
  const int kend = max(0, min(min(last, sl + max_i) + 1, width * bs));
  const int nt = (kend + KT - 1) / KT;
  const int t_lo = rank * nt / cl, n = (rank + 1) * nt / cl - t_lo;

  for (int e = tid; e < width; e += blockDim.x)
    bt_s[e] = bt[(size_t)b * width + e];
  for (int e = tid; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, ch = e % CH, j = j0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nrows && ch * 8 < hd)
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + j % S) * H + h * G + j / S) * hd + ch * 8);
    *reinterpret_cast<uint4*>(q_s + (r / 64) * L::Q +
                              (ch / 8) * 64 * PANEL_ROW +
                              sw128_off(r % 64, ch % 8)) = val;
  }
  fence_proxy_async();
  __syncthreads();  // bt_s and Q are in place

  // tile t of the request's keys into stage st: K then V, HD/64 panels each
  auto issue = [&](int t, int st) {
    const uint32_t kdst = smem_u32(kv_s + st * 2 * L::KV);
    for (int e = tid; e < KT * CH; e += blockDim.x) {
      const int kr = e / CH, ch = e % CH, pos = t * KT + kr;
      const bool ok = pos < kend && ch * 8 < hd;
      const size_t off =
          ok ? (((size_t)bt_s[pos / bs] * bs + pos % bs) * hkv + h) * hd +
                   ch * 8
             : 0;
      const uint32_t d = kdst + (ch / 8) * KT * PANEL_ROW + sw128_off(kr, ch % 8);
      cp_async16(d, kpool + off, ok);
      cp_async16(d + L::KV, vpool + off, ok);
    }
  };

  // this thread's rows r0 and r0 + 8 of its warpgroup's 64; query position
  // clamped to the live keys (rows past num_new are don't-care, finite)
  const int warp = tid / 32, wg = warp / 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + (tid % 32) / 4;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    qpos[hh] = r < nrows ? min(sl + (j0 + r) % S, kend - 1) : -1;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  // the ring: tile it + AHEAD is copied while tile it is computed, into
  // the stage of tile it - 2, whose P V finished a step ago
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    if (a < n) issue(t_lo + a, a);
    cp_async_commit();
  }
  float s[KT / 2], corr[2];
  uint32_t p[KT / 4];
  const uint32_t qa = smem_u32(q_s + wg * L::Q);
  auto next = [&](int it) {  // tile it has landed; tile it + AHEAD issued
    cp_async_wait<AHEAD - 1>();  // this thread's copies of tile it landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed; tile it - 2 is consumed
    if (it + AHEAD < n) issue(t_lo + it + AHEAD, (it + AHEAD) % NST);
    cp_async_commit();
    return smem_u32(kv_s + (it % NST) * 2 * L::KV);
  };
  if (n > 0) {  // the first tile is peeled: no P V is pending before it
    uint32_t kt = next(0);
    flash_step<KT, HD, true, false>(s, o, p, m, l, corr, sl2, t_lo * KT,
                                    qpos, qa, kt, 0);
    for (int it = 1; it < n; ++it) {
      const uint32_t v_prev = kt + L::KV;
      kt = next(it);
      flash_step<KT, HD, true, true>(s, o, p, m, l, corr, sl2,
                                     (t_lo + it) * KT, qpos, qa, kt, v_prev);
    }
    flash_drain<KT, HD>(o, p, corr, kt + L::KV);
  }

  const int c2 = (tid & 3) * 2;
  if (cl > 1) {
    cp_async_wait<0>();
    __syncthreads();  // the stages are free for the partials
    if (rank > 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if ((tid & 3) == 0) {
          m_s[r] = m[hh];
          l_s[r] = l[hh];
        }
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb)
          *reinterpret_cast<float2*>(part + r * HD + 8 * nb + c2) =
              make_float2(o[4 * nb + 2 * hh], o[4 * nb + 2 * hh + 1]);
      }
    }
    cluster.sync();  // every split's partials are published
    if (rank == 0) {
      for (int src = 1; src < cl; ++src) {  // rank order
        const float* rm = cluster.map_shared_rank(m_s, src);
        const float* rl = cluster.map_shared_rank(l_s, src);
        const float* rp = cluster.map_shared_rank(part, src);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh;
          const float mq = rm[r];
          const float m_new = fmaxf(m[hh], mq);
          const float a = ex2(m[hh] - m_new), c = ex2(mq - m_new);
          l[hh] = l[hh] * a + rl[r] * c;
          m[hh] = m_new;
#pragma unroll
          for (int nb = 0; nb < HD / 8; ++nb) {
            const float2 x =
                *reinterpret_cast<const float2*>(rp + r * HD + 8 * nb + c2);
            o[4 * nb + 2 * hh] = o[4 * nb + 2 * hh] * a + x.x * c;
            o[4 * nb + 2 * hh + 1] = o[4 * nb + 2 * hh + 1] * a + x.y * c;
          }
        }
      }
    }
    cluster.sync();  // no block leaves while rank 0 still reads it
    if (rank > 0) return;
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows<HD>(o, inv, q_s + wg * L::Q, hd,
                 [&](int r) -> bf16* {
                   const int rr = 64 * wg + r, j = j0 + rr;
                   if (rr >= nrows) return nullptr;
                   return out +
                          (((size_t)b * S + j % S) * H + h * G + j / S) * hd;
                 },
                 1 + wg);
}

template <int HD>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* bt, const void* seq_lens, const void* num_new,
           void* out, int B, int S, int hkv, int G, int hd, int bs, int width,
           float scale, int rows, int cl, cudaStream_t stream) {
  const int nwg = rows / 64;
  const size_t smem = Layout<HD>::smem(nwg, width);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((G * S + rows - 1) / rows * cl, hkv, B);
  cfg.blockDim = dim3(128 * nwg, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, chunk_wgmma_kernel<HD>, (const bf16*)q,
                         (const bf16*)kpool, (const bf16*)vpool,
                         (const int*)bt, (const int*)seq_lens,
                         (const int*)num_new, (bf16*)out, S, hkv, G, hd, bs,
                         width, scale * LOG2E, cl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd) bf16; kpool/vpool (N, bs, Hkv, hd) bf16; block_tables
// (B, W) int32; seq_lens, num_new (B,) int32; out (B, S, H, hd) bf16.
// Requires hd % 8 == 0 and hd <= 128. rows (64 or 128 query rows a block)
// and cl (1..8 blocks a cluster) are the host plan's
// (attention_plan.chunk_plan).
extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* kpool, const void* vpool, const void* bt,
    const void* seq_lens, const void* num_new, void* out, int B, int S, int H,
    int hkv, int hd, int bs, int width, float scale, int rows, int cl,
    void* stream) {
  const int G = H / hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if ((rows != 64 && rows != 128) || cl < 1 || cl > MAX_CL)
    return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return launch<64>(q, kpool, vpool, bt, seq_lens, num_new, out, B, S, hkv,
                      G, hd, bs, width, scale, rows, cl, s);
  return launch<128>(q, kpool, vpool, bt, seq_lens, num_new, out, B, S, hkv,
                     G, hd, bs, width, scale, rows, cl, s);
}
