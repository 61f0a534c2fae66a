// K3: paged decode attention, flash-decoding style, in one launch.
//
// Replaces src/repro/kernels/paged_decode_attention.py:77
// paged_decode_attention_pallas (its _decode_kernel and the merge of its
// splits, :127-134): one query token per request attends its paged KV
// history in place, reading the block table in the kernel; the live keys
// are split over the blocks of a thread-block cluster, each with an f32
// online softmax, and the splits are merged in the kernel, which writes the
// bf16 output.
//
// What bounds it on the H100: bytes -- every live K and V row is read once
// (4 requests x 512 cached tokens x 32 heads x 64 dims x 2 B x 2 = 16.8 MB
// per paper-0.5b layer, 5 us at 3.35 TB/s); the flops are 4 per cached
// element. So the pages must stream at the memory rate: enough blocks,
// each with copies in flight while it computes.
//
// Design (sm90_common.cuh; the staging and the merge follow K4,
// paged_chunk_attention.cu):
//   * grid (cluster rank, kv head, request); the CL blocks of a (request,
//     kv head) form a cluster. CL comes from the host plan
//     (kernels/attention_plan.py: decode_plan, from shapes and the SM
//     count, never seq_lens): the widest cluster (<= 8, <= the table's
//     64-key tiles) that keeps every cluster resident at once;
//   * the request's seq_len + 1 live keys (the new token was scattered at
//     position seq_len before the read) are split on the card into 64-key
//     tiles, rank r taking tiles r*nt/CL .. (r+1)*nt/CL - 1 of nt
//     (attention_plan.decode_splits); a rank may get none;
//   * a block is one warpgroup. It caches its pages' block-table entries
//     and the G query rows of its kv head (GQA without repeat_kv: h = hkv *
//     G + g) in shared memory, and stages its tiles through a ring of NST
//     stages: every thread copies 16-byte pieces of key rows with cp.async
//     into the 128B-swizzled layout wgmma reads (zero-filled past the
//     rank's keys and past hd), one cp.async group a tile, AHEAD = 2 tiles
//     ahead of the one computed. cp.async and not TMA, for K4's reason: a
//     tile gathers 64 / bs pages and bs varies;
//   * both products on wgmma in the swap-AB form, since one query row per
//     head makes N tiny (G rounded up to 8 or 16): S^T (64 keys x N) = K
//     Q^T with A = the K tile, K-major (WgmmaKA); O^T (hd x N) += V^T P^T
//     with A = the V tile read MN-major (WgmmaTA) and P^T in shared memory
//     as B. The f32 softmax runs in base 2 on S^T's accumulators; the
//     tile's max per head is reduced over the warpgroup through shared
//     memory, the sums stay per thread until the end. P keeps f32
//     precision as the Pallas body's does: it goes to the product as two
//     bf16 operands, P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmmas;
//   * merge: each rank writes its (m, l) and f32 O^T to its own shared
//     memory (over the ring); after a cluster barrier every rank merges a
//     share of the output's 8-element pieces, reading all ranks' partials
//     through distributed shared memory in rank order, and stores acc /
//     max(l, 1e-30) rounded once to bf16 -- no partials in HBM, no second
//     launch, no atomics, the same bits every run. A rank with no live key
//     holds m = -1e30, l = 0, acc = 0 and adds exactly 0; a padded batch
//     row (seq_len 0, all-null table) reads key 0 of the null block and
//     stays finite.
// Every branch around a wgmma depends only on values uniform over the
// block (the rank's tile count), so ptxas keeps the wgmmas asynchronous;
// the accumulators' zeroing is fenced off (fence_regs, C7515).
// The C entry point launches the head-dim template hd <= 64 -> 64, else
// 128 (hd 16..56 zero-padded to one 64-column panel, 72..120 to two).
#include <cooperative_groups.h>

#include "attention_sm90.cuh"

namespace cg = cooperative_groups;
using namespace sm90;

namespace {

constexpr int KT = 64;          // keys per tile
constexpr int NST = 3;          // stages in the ring
constexpr int AHEAD = NST - 1;  // tiles in flight ahead of the one computed
constexpr int MAX_CL = 8;
constexpr int THREADS = 128;    // one warpgroup

// Shared memory (1024-aligned panels first): the ring of NST (K, V) tiles,
// each HD/64 panels of KT key rows; Q^T's N rows, HD/64 panels; P^T hi and
// lo, N rows of KT keys each; the tile max of each warp [4][N]; the
// block's m and l [N]; the block-table entries [width]. After the key loop
// the f32 partial O^T [N][PS] is aliased over the ring.
template <int HD, int N>
struct Layout {
  static constexpr uint32_t KV = (HD / 64) * KT * PANEL_ROW;  // a K or V tile
  static constexpr uint32_t QP = N * PANEL_ROW;  // a 64-dim panel of Q
  static constexpr uint32_t Q = (HD / 64) * QP;
  static constexpr uint32_t PT = N * PANEL_ROW;  // P^T: N rows of KT keys
  static constexpr int PS = HD + 4;              // partial row stride
  static_assert(N * PS * 4 <= NST * 2 * KV, "partials fit the ring");
  static size_t smem(int width) {
    return 1024 + NST * 2 * KV + Q + 2 * PT + sizeof(float) * 6 * N +
           sizeof(int) * width;
  }
};

template <int HD, int N>
__global__ void __launch_bounds__(THREADS, 4)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                  const bf16* __restrict__ vpool, const int* __restrict__ bt,
                  const int* __restrict__ seq_lens, bf16* __restrict__ out,
                  int hkv, int G, int hd, int bs, int width, float sl2) {
  typedef Layout<HD, N> L;
  constexpr int CH = HD / 8;  // 16-byte chunks of a padded row
  constexpr int NC = N / 4;   // the thread's columns (query heads)
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  uint8_t* sm = smem_aligned(smem_tiles);
  uint8_t* ring = sm;                                   // [NST] K, V tiles
  uint8_t* q_s = ring + NST * 2 * L::KV;                // Q^T panels
  uint8_t* pt_s = q_s + L::Q;                           // P^T hi, lo
  float* red = reinterpret_cast<float*>(pt_s + 2 * L::PT);  // [4][N]
  float* m_s = red + 4 * N;                                 // [N]
  float* l_s = m_s + N;                                     // [N]
  int* bt_s = reinterpret_cast<int*>(l_s + N);              // [width]
  float* part = reinterpret_cast<float*>(ring);  // [N][PS], after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, c2 = (lane % 4) * 2;
  const int H = hkv * G;

  // this rank's tiles of the request's live keys 0 .. kend - 1
  const int kend = min(seq_lens[b] + 1, width * bs);
  const int nt = (kend + KT - 1) / KT;
  const int t_lo = rank * nt / cl, n = (rank + 1) * nt / cl - t_lo;
  const int hi = min((t_lo + n) * KT, kend);  // the rank's keys end here

  if (n > 0)
    for (int e = t_lo * KT / bs + tid; e <= (hi - 1) / bs; e += THREADS)
      bt_s[e] = bt[(size_t)b * width + e];
  for (int e = tid; e < N * CH; e += THREADS) {
    const int r = e / CH, ch = e % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < G && ch * 8 < hd)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + hk * G + r) * hd + ch * 8);
    *reinterpret_cast<uint4*>(q_s + (ch / 8) * L::QP + sw128_off(r, ch % 8)) =
        val;
  }
  fence_proxy_async();
  __syncthreads();  // bt_s and Q^T are in place

  // tile t of the request's keys into stage st: K then V, HD/64 panels each
  auto issue = [&](int t, int st) {
    const uint32_t kdst = smem_u32(ring + st * 2 * L::KV);
    for (int e = tid; e < KT * CH; e += THREADS) {
      const int kr = e / CH, ch = e % CH, pos = t * KT + kr;
      const bool ok = pos < hi && ch * 8 < hd;
      const size_t off =
          ok ? (((size_t)bt_s[pos / bs] * bs + pos % bs) * hkv + hk) * hd +
                   ch * 8
             : 0;
      const uint32_t d =
          kdst + (ch / 8) * KT * PANEL_ROW + sw128_off(kr, ch % 8);
      cp_async16(d, kpool + off, ok);
      cp_async16(d + L::KV, vpool + off, ok);
    }
  };

  // S^T / O^T accumulator element 4j + 2h + e of this thread: row (key of
  // the tile, or head dim of the slab) 16 warp + g8 + 8h, column (query
  // head) 8j + c2 + e; the thread's columns are indexed 2j + e
  float m[NC], lsum[NC], corr[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    m[i] = NEG;
    lsum[i] = 0.f;
  }
  float o[HD / 64][N / 2];
#pragma unroll
  for (int sl = 0; sl < HD / 64; ++sl)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[sl][i] = 0.f;
#pragma unroll
  for (int sl = 0; sl < HD / 64; ++sl) fence_regs<N / 2>(o[sl]);
  float s[N / 2];
  const uint32_t qa = smem_u32(q_s), pa = smem_u32(pt_s);

#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    if (a < n) issue(t_lo + a, a);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of tile it landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; tile it - 1's stage is consumed
    if (it + AHEAD < n) issue(t_lo + it + AHEAD, (it + AHEAD) % NST);
    cp_async_commit();
    const uint32_t kt = smem_u32(ring + (it % NST) * 2 * L::KV);
    const uint32_t vt = kt + L::KV;

    // S^T = K Q^T, 16 head dims a step
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
    fence_regs<N / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      WgmmaKA<N>::mma(s, sw128_desc(kt + (kk / 4) * KT * PANEL_ROW + off, 0),
                      sw128_desc(qa + (kk / 4) * L::QP + off, 0));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(s);

    // the tile's max of each head over its keys: the thread's two keys,
    // the warp's 8 lane groups, then the 4 warps through shared memory
    const int k0 = (t_lo + it) * KT;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = NEG;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          if (k0 + 16 * warp + g8 + 8 * h >= hi) x = NEG;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (g8 == 0) red[warp * N + 8 * j + c2 + e] = mx;
      }
    __syncthreads();

    // online softmax in base 2: p = 2^(s sl2 - m); P^T as bf16 hi + lo
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e, i = 2 * j + e;
        const float mt = fmaxf(fmaxf(red[col], red[N + col]),
                               fmaxf(red[2 * N + col], red[3 * N + col]));
        const float m_new = fmaxf(m[i], mt * sl2);
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = 16 * warp + g8 + 8 * h;
          const float x = s[4 * j + 2 * h + e];
          const float p = k0 + kr < hi ? ex2(fmaf(x, sl2, -m_new)) : 0.f;
          sum += p;
          const bf16 ph = __float2bfloat16_rn(p);
          const bf16 pl = __float2bfloat16_rn(p - __bfloat162float(ph));
          uint8_t* a = pt_s + sw128_off(col, kr / 8) + (kr % 8) * 2;
          *reinterpret_cast<bf16*>(a) = ph;
          *reinterpret_cast<bf16*>(a + L::PT) = pl;
        }
        lsum[i] = lsum[i] * corr[i] + sum;
      }
#pragma unroll
    for (int sl = 0; sl < HD / 64; ++sl)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[sl][4 * j + 2 * h + e] *= corr[2 * j + e];
    // the rescaled accumulators are final before the wgmmas read them
#pragma unroll
    for (int sl = 0; sl < HD / 64; ++sl) fence_regs<N / 2>(o[sl]);
    fence_proxy_async();
    __syncthreads();  // P^T is in place for the async proxy

    // O^T += V^T P_hi^T + V^T P_lo^T, 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int part_lo = 0; part_lo < 2; ++part_lo)
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int sl = 0; sl < HD / 64; ++sl)
          WgmmaTA<N>::mma(
              o[sl],
              sw128_desc(vt + sl * KT * PANEL_ROW + kk * 16 * PANEL_ROW,
                         KT * PANEL_ROW),
              sw128_desc(pa + part_lo * L::PT + kk * 32, 0));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < HD / 64; ++sl) fence_regs<N / 2>(o[sl]);
  }

  // the block's l of each head: the thread's sums over the lane groups,
  // then the 4 warps in order
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float v = lsum[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    lsum[i] = v + __shfl_xor_sync(0xffffffffu, v, 16);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and red are free
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + c2 + e;
      if (g8 == 0) red[warp * N + col] = lsum[2 * j + e];
#pragma unroll
      for (int sl = 0; sl < HD / 64; ++sl)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          part[col * L::PS + 64 * sl + 16 * warp + g8 + 8 * h] =
              o[sl][4 * j + 2 * h + e];
    }
  __syncthreads();
  if (warp == 0 && g8 == 0)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e;
        m_s[col] = m[2 * j + e];
        l_s[col] = ((red[col] + red[N + col]) + red[2 * N + col]) +
                   red[3 * N + col];
      }
  cluster.sync();  // every rank's partials are published

  // the merge, spread over the ranks by 8-element pieces of the output
  // (G x hd contiguous bf16 of this kv head): every rank's partial in
  // rank order, then acc / max(l, 1e-30) rounded once to bf16
  const int pieces = G * hd / 8;
  for (int pc = rank + cl * tid; pc < pieces; pc += cl * THREADS) {
    const int gg = pc * 8 / hd, d = pc * 8 % hd;
    float mx = NEG;
    for (int src = 0; src < cl; ++src)
      mx = fmaxf(mx, cluster.map_shared_rank(m_s, src)[gg]);
    float l = 0.f, acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int src = 0; src < cl; ++src) {
      const float a = ex2(cluster.map_shared_rank(m_s, src)[gg] - mx);
      l += a * cluster.map_shared_rank(l_s, src)[gg];
      const float4* rp = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + gg * L::PS + d);
      const float4 x0 = rp[0], x1 = rp[1];
      acc[0] += a * x0.x;
      acc[1] += a * x0.y;
      acc[2] += a * x0.z;
      acc[3] += a * x0.w;
      acc[4] += a * x1.x;
      acc[5] += a * x1.y;
      acc[6] += a * x1.z;
      acc[7] += a * x1.w;
    }
    const float den = fmaxf(l, 1e-30f);
    uint4 v;
    v.x = pack_bf16(acc[0] / den, acc[1] / den);
    v.y = pack_bf16(acc[2] / den, acc[3] / den);
    v.z = pack_bf16(acc[4] / den, acc[5] / den);
    v.w = pack_bf16(acc[6] / den, acc[7] / den);
    *reinterpret_cast<uint4*>(out + ((size_t)b * H + hk * G + gg) * hd + d) =
        v;
  }
  cluster.sync();  // no block leaves while another still reads it
}

template <int HD, int N>
int configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid,
              int width, int cl, cudaStream_t stream) {
  const size_t smem = Layout<HD, N>::smem(width);
  const cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <int HD, int N>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* bt, const void* seq_lens, void* out, int B, int hkv,
           int G, int hd, int bs, int width, float scale, int cl,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<HD, N>(&cfg, &attr, dim3(cl, hkv, B), width, cl,
                                 stream);
  if (e) return e;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<HD, N>, (const bf16*)q, (const bf16*)kpool,
      (const bf16*)vpool, (const int*)bt, (const int*)seq_lens, (bf16*)out,
      hkv, G, hd, bs, width, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD, int N>
int resident(int width, int cl, int* clusters, int* smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int e = configure<HD, N>(&cfg, &attr, dim3(cl, 1, 1), width, cl, 0);
  if (e) return e;
  *smem = (int)Layout<HD, N>::smem(width);
  return (int)cudaOccupancyMaxActiveClusters(clusters, decode_kernel<HD, N>,
                                             &cfg);
}

}  // namespace

// q (B, 1, H, hd) bf16; kpool/vpool (N, bs, Hkv, hd) bf16; block_tables
// (B, W) int32; seq_lens (B,) int32; out (B, 1, H, hd) bf16. Requires
// hd % 8 == 0, hd <= 128, G = H / Hkv <= 16 and 16-byte aligned q and
// pools. cl (1..8 blocks a cluster, splitting the keys) is the host plan's
// (attention_plan.decode_plan).
extern "C" int paged_decode_attention_bf16(const void* q, const void* kpool,
                                           const void* vpool, const void* bt,
                                           const void* seq_lens, void* out,
                                           int B, int H, int hkv, int hd,
                                           int bs, int width, float scale,
                                           int cl, void* stream) {
  const int G = H / hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (cl < 1 || cl > MAX_CL || G < 1 || G > 16 || hd > 128 || hd % 8)
    return (int)cudaErrorInvalidValue;
#define DECODE_LAUNCH(HD, N)                                                 \
  return launch<HD, N>(q, kpool, vpool, bt, seq_lens, out, B, hkv, G, hd, bs, \
                       width, scale, cl, s);
  if (hd <= 64) {
    if (G <= 8) DECODE_LAUNCH(64, 8)
    DECODE_LAUNCH(64, 16)
  }
  if (G <= 8) DECODE_LAUNCH(128, 8)
  DECODE_LAUNCH(128, 16)
#undef DECODE_LAUNCH
}

// The CUDA runtime's count of clusters of cl blocks the current card holds
// at once (cudaOccupancyMaxActiveClusters) for the form that serves (hd,
// G) at a table width, and that form's dynamic shared memory. For checking
// decode_plan; the kernel path does not call it.
extern "C" int paged_decode_resident_clusters(int hd, int G, int width,
                                              int cl, int* clusters,
                                              int* smem) {
  if (cl < 1 || cl > MAX_CL || G < 1 || G > 16 || hd > 128 || hd % 8)
    return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return G <= 8 ? resident<64, 8>(width, cl, clusters, smem)
                  : resident<64, 16>(width, cl, clusters, smem);
  return G <= 8 ? resident<128, 8>(width, cl, clusters, smem)
                : resident<128, 16>(width, cl, clusters, smem);
}
