// K3: paged decode attention, flash-decoding style.
//
// Replaces src/repro/kernels/paged_decode_attention.py:77
// paged_decode_attention_pallas (its _decode_kernel): one query token per
// request attends its paged KV history in place, reading the block table in
// the kernel; split-K over the live pages with an f32 online softmax per
// split, partial (o, m, l) written out and merged by the caller (plain
// torch ops, as the JAX wrapper merges outside its kernel).
//
// What bounds it on the H100: bytes -- every live K and V row is read once
// (4 requests x 512 cached tokens x 32 heads x 64 dims x 2 B x 2 = 16.8 MB
// per paper-0.5b layer, 5 us at 3.35 TB/s); the flops are 4 per cached
// element.
//
// Design:
//   * grid (request, kv head, split); a split covers ceil(W / splits) table
//     pages, of which only the live keys (kpos <= seq_len: the new token was
//     scattered at position seq_len before the read) are read;
//   * the block caches its split's block-table entries in shared memory;
//     inside the block the split's keys go round-robin, 32 at a time, to
//     the four warps; each warp stages its own tile (16-byte loads, f32 in
//     shared memory) and keeps its own online-softmax state for each of the
//     block's G query heads (GQA without repeat_kv: h = hkv * G + g); the
//     warps' states merge in shared memory at the end, so even at G = 1
//     every warp and every lane works;
//   * padded batch rows (seq_len 0, all-null table) read one key of the
//     null block and stay finite; a dead split writes m = -1e30, l = 0,
//     o = 0 and contributes exactly 0 to the merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// Layout: a tile holds KT = 32 consecutive key positions of one request and
// one kv head, gathered through the block table (a tile may span pages).
// Lane j of a warp scores key j; the head dim is padded to HD (32, 64 or
// 128, a template parameter so the dot products unroll), the padding
// zero-filled, and lane l accumulates output dims l, l+32, ...
// Numerics follow src/repro/kernels/ref.py paged_attention_decode: f32
// logits (q . k) * scale, f32 softmax with the running max starting at
// -1e30, f32 accumulation of p * v.

constexpr int KT = 32;            // keys per tile = lanes per warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
struct Tile {
  float k[KT][HD + 1];  // +1: lanes reading different keys hit different banks
  float v[KT][HD];
};

// Zero the padded head dims once; tiles rewrite only dims < hd.
template <int HD>
__device__ __forceinline__ void clear_tile(Tile<HD>& t, int tid, int nthr) {
  float* p = &t.k[0][0];
  for (int e = tid; e < KT * (HD + 1) + KT * HD; e += nthr) p[e] = 0.f;
}

// Stage keys k0 .. k0+KT-1 of kv head h (positions >= kcount zero-filled)
// into `t` as f32, by the calling group of `nthr` threads (index `tid`
// within it). Pools are (N, bs, Hkv, hd) with hd % 8 == 0; bt_row is the
// request's block table. Rounds of RND 16-byte chunks of K and of V per
// thread: all of a round's loads are in flight before any is stored.
template <int HD>
__device__ __forceinline__ void load_tile(Tile<HD>& t,
                                          const bf16* __restrict__ kpool,
                                          const bf16* __restrict__ vpool,
                                          const int* __restrict__ bt_row,
                                          int bs, int hkv, int h, int hd,
                                          int k0, int kcount, int tid,
                                          int nthr) {
  constexpr int RND = 4;
  const int cpk = hd / 8;  // 16-byte chunks per key row
  const int total = KT * cpk;
  for (int base = tid; base < total; base += RND * nthr) {
    uint4 ku[RND], vu[RND];
#pragma unroll
    for (int c = 0; c < RND; ++c) {
      const int e = base + c * nthr;
      ku[c] = make_uint4(0, 0, 0, 0);
      vu[c] = make_uint4(0, 0, 0, 0);
      const int pos = k0 + e / cpk;
      if (e < total && pos < kcount) {
        const int blk = bt_row[pos / bs];
        const size_t off =
            (((size_t)blk * bs + pos % bs) * hkv + h) * hd + (e % cpk) * 8;
        ku[c] = *reinterpret_cast<const uint4*>(kpool + off);
        vu[c] = *reinterpret_cast<const uint4*>(vpool + off);
      }
    }
#pragma unroll
    for (int c = 0; c < RND; ++c) {
      const int e = base + c * nthr;
      if (e >= total) break;
      const int j = e / cpk, d0 = (e % cpk) * 8;
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&ku[c]);
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&vu[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 kf = __bfloat1622float2(kp[i]);
        const float2 vf = __bfloat1622float2(vp[i]);
        t.k[j][d0 + 2 * i] = kf.x;
        t.k[j][d0 + 2 * i + 1] = kf.y;
        t.v[j][d0 + 2 * i] = vf.x;
        t.v[j][d0 + 2 * i + 1] = vf.y;
      }
    }
  }
}

// Online-softmax state of one query row; lane owns dims lane + 32*i.
template <int HD>
struct Row {
  float m, l;
  float acc[HD / 32];
  __device__ void init() {
    m = NEG;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) acc[i] = 0.f;
  }
};

// Fold the tile's keys k0 .. k0+KT-1 into `row`; keys with kpos > kmax are
// masked out. q: the row's query, f32, padded to HD, in shared memory.
template <int HD>
__device__ __forceinline__ void tile_update(Row<HD>& row, const float* q,
                                            const Tile<HD>& t, int k0,
                                            int kmax, float scale, int lane) {
  const bool on = k0 + lane <= kmax;
  float s = NEG;
  if (on) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < HD; ++e) d = fmaf(q[e], t.k[lane][e], d);
    s = d * scale;
  }
  const float mx = warp_max(s);
  if (mx == NEG) return;  // every key of the tile masked (warp-uniform)
  const float m_new = fmaxf(row.m, mx);
  const float p = on ? expf(s - m_new) : 0.f;
  const float corr = expf(row.m - m_new);
  row.l = row.l * corr + warp_sum(p);
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) row.acc[i] *= corr;
#pragma unroll 8
  for (int j = 0; j < KT; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      row.acc[i] = fmaf(pj, t.v[j][lane + 32 * i], row.acc[i]);
  }
  row.m = m_new;
}

constexpr int NWARPS = 4;
constexpr int GMAX = 16;  // query heads per kv head

template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                  const bf16* __restrict__ vpool, const int* __restrict__ bt,
                  const int* __restrict__ seq_lens, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int hkv, int G, int hd, int bs, int width, int ns,
                  int pages, float scale) {
  extern __shared__ float smem[];
  Tile<HD>* tiles = reinterpret_cast<Tile<HD>*>(smem);  // one per warp
  float* q_s = smem + NWARPS * sizeof(Tile<HD>) / sizeof(float);  // [G][HD]
  int* bt_s = reinterpret_cast<int*>(q_s + G * HD);     // [pages]

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = hkv * G;
  const int sl = seq_lens[b];
  const int p0 = split * pages;
  const int np = min(pages, width - p0);  // this split's table entries

  for (int e = threadIdx.x; e < np; e += blockDim.x)
    bt_s[e] = bt[(size_t)b * width + p0 + e];
  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) {
    const int g = e / HD, d = e % HD;
    q_s[e] = d < hd ? __bfloat162float(q[((size_t)b * H + h * G + g) * hd + d])
                    : 0.f;
  }
  for (int w = 0; w < NWARPS; ++w)
    clear_tile(tiles[w], threadIdx.x, blockDim.x);
  __syncthreads();

  Row<HD> rows[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) rows[g].init();

  // this split's live keys, numbered from its first page
  const int kbeg = p0 * bs;
  const int kend = min(max(np, 0) * bs, sl + 1 - kbeg);
  Tile<HD>& t = tiles[warp];
  for (int k0 = warp * KT; k0 < kend; k0 += NWARPS * KT) {
    load_tile(t, kpool, vpool, bt_s, bs, hkv, h, hd, k0, kend, lane, 32);
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G)
        tile_update(rows[g], q_s + g * HD, t, k0, kend - 1, scale, lane);
    __syncwarp();
  }

  // merge the four warps' states: (m, l) and acc per query head
  __syncthreads();
  float* part_acc = smem;                          // [NWARPS][G][HD]
  float* part_m = part_acc + NWARPS * G * HD;      // [NWARPS][G]
  float* part_l = part_m + NWARPS * G;             // [NWARPS][G]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      part_acc[(warp * G + g) * HD + lane + 32 * i] = rows[g].acc[i];
    if (lane == 0) {
      part_m[warp * G + g] = rows[g].m;
      part_l[warp * G + g] = rows[g].l;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd, d = e % hd;
    float m = NEG;
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, part_m[w * G + g]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float a = expf(part_m[w * G + g] - m);
      l += a * part_l[w * G + g];
      acc += a * part_acc[(w * G + g) * HD + d];
    }
    const size_t row = (((size_t)b * hkv + h) * ns + split) * G + g;
    o[row * hd + d] = acc;
    if (d == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

template <int HD>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* bt, const void* seq_lens, void* o, void* m, void* l,
           int B, int hkv, int G, int hd, int bs, int width, int ns,
           float scale, cudaStream_t stream) {
  const int pages = (width + ns - 1) / ns;
  const size_t tiles = NWARPS * sizeof(Tile<HD>) + sizeof(float) * G * HD +
                       sizeof(int) * pages;
  const size_t merge = sizeof(float) * NWARPS * G * (HD + 2);
  const size_t smem = tiles > merge ? tiles : merge;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, hkv, ns);
  decode_kernel<HD><<<grid, NWARPS * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)kpool, (const bf16*)vpool, (const int*)bt,
      (const int*)seq_lens, (float*)o, (float*)m, (float*)l, hkv, G, hd, bs,
      width, ns, pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, hd) bf16; kpool/vpool (N, bs, Hkv, hd) bf16; block_tables
// (B, W) int32; seq_lens (B,) int32. Partial outputs: o (B, Hkv, ns, G, hd),
// m and l (B, Hkv, ns, G), all float32. ns splits of ceil(W / ns) pages.
// Requires hd % 8 == 0, hd <= 128 and G = H / Hkv <= 16.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* kpool, const void* vpool, const void* bt,
    const void* seq_lens, void* o, void* m, void* l, int B, int H, int hkv,
    int hd, int bs, int width, int ns, float scale, void* stream) {
  const int G = H / hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32)
    return launch<32>(q, kpool, vpool, bt, seq_lens, o, m, l, B, hkv, G, hd,
                      bs, width, ns, scale, s);
  if (hd <= 64)
    return launch<64>(q, kpool, vpool, bt, seq_lens, o, m, l, B, hkv, G, hd,
                      bs, width, ns, scale, s);
  return launch<128>(q, kpool, vpool, bt, seq_lens, o, m, l, B, hkv, G, hd,
                     bs, width, ns, scale, s);
}
