// K5: gated FFN end to end with (row block x hidden tile) skipping.
//
// Replaces src/repro/kernels/sparse_ffn.py:159 tile_skip_ffn_pallas (its
// body _kernel_gated_dense_gate, :130), extended by the per-(row, tile)
// threshold of src/repro/kernels/ref.py:33 tile_skip_ffn:
//   g  = act(x @ W_g)                       f32, act = relu | relu^2
//   row m drops tile j when max|g[m, tile j]| <= threshold
//   a (32-row block, tile) cell whose rows all dropped the tile skips its
//   W_u and W_d work (at threshold 0: every g of the cell is zero, the
//   Pallas predicate jnp.any(g > 0))
//   hu = x @ W_u[:, tile]                   f32
//   h  = bf16(hu * g)                       rounded once, as the Pallas body
//   y  = sum over active tiles, in tile order, of h @ W_d[tile, :]   f32
// and h (M, N) is written for every (row, tile), zeros where dropped.
//
// What bounds it on the H100: bytes. Every call reads all of W_g (23.1 MB
// per paper-0.5b layer); each tile that any active cell needs adds its
// slices of W_u and W_d (2 x 1 MB). At decode (M <= 4) the products are
// negligible beside that; at a 256-row chunk the 17.7 GFLOP of three full
// products still take less time than the 69 MB of weights.
//
// Design: two kernels, one launch sequence on the caller's stream.
//   * up: one block per (32-row block, 32-column slice of a tile); the
//     T/32 slices of one tile form a thread-block cluster. Each block
//     computes its g slice with WMMA bf16 16x16x16 products over a
//     three-stage cp.async pipeline, publishes its per-row max in shared
//     memory, and after a cluster barrier reads all slices' maxima through
//     distributed shared memory: every block of the cluster reaches the
//     same keep/skip decision for the whole tile without a second pass
//     over device memory. An active cell runs the W_u product for its
//     slice, and h = bf16(hu * g) is written; a skipped cell writes zeros
//     and never reads W_u. The cluster's rank 0 records the cell's flag.
//   * down: one block per (32-row block, 32 columns of y); it lists the
//     active tiles of its row block from the flags and accumulates
//     h[:, tile] @ W_d[tile, :] over them in tile order inside the block,
//     so y needs no float atomics and is the same from run to run (the
//     TPU grid summed y in place over its sequential tile axis).
//   * rows past M are zero-filled by the copy and never written.
// Later work: at decode the up kernel streams W_g with 176 blocks and the
// down kernel W_d with 64; splitting their K loops over clusters (as K1
// does) and wgmma/TMA tiles are the next steps.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;         // rows per block
constexpr int BN = 32;         // output columns per block
constexpr int BK = 32;         // depth per pipeline stage
constexpr int NSTAGE = 3;      // cp.async pipeline depth
constexpr int AS = BK + 8;     // A stage row stride (elements; 80 bytes)
constexpr int BS = BN + 8;     // B stage row stride
constexpr int FS = BN + 4;     // f32 tile row stride
constexpr int NTHREADS = 128;  // 4 warps: 2 row x 2 column 16x16 fragments
constexpr int MAX_TILES = 1024;

// raw 16-bit storage, read by WMMA as bf16
struct Stage {
  uint16_t a[BM * AS];
  uint16_t b[BK * BS];
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes = zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage: A rows row0 .. row0+31 (those below M), columns acol0 .. +31
// of a row-major matrix with leading dimension lda; B rows brow0 .. +31,
// columns bcol0 .. +31 (leading dimension ldb). One 16-byte copy each per
// thread.
__device__ __forceinline__ void load_stage(Stage& st, const bf16* a, int lda,
                                           int M, int row0, int acol0,
                                           const bf16* b, int ldb, int brow0,
                                           int bcol0) {
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 8;
  const bool ok = row0 + r < M;
  cp_async16(&st.a[r * AS + c],
             ok ? a + (size_t)(row0 + r) * lda + acol0 + c : a, ok);
  cp_async16(&st.b[r * BS + c], b + (size_t)(brow0 + r) * ldb + bcol0 + c,
             true);
}

// acc = sum over nk stages of A_stage @ B_stage; load(stage, kt) queues the
// copies of stage kt. Leaves every stage consumed and the block in step.
template <class Load>
__device__ __forceinline__ void mma_loop(Stage* st, int nk, Load load,
                                         Acc& acc, int rf, int cf) {
  wmma::fill_fragment(acc, 0.f);
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(st[s], s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();  // stage kt has landed
    __syncthreads();              // ... and stage kt - 1 is consumed
    const int nxt = kt + NSTAGE - 1;
    if (nxt < nk) load(st[nxt % NSTAGE], nxt);
    cp_async_commit();
    const Stage& s = st[kt % NSTAGE];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(
          fa, reinterpret_cast<const bf16*>(&s.a[(rf * 16) * AS + kk]), AS);
      wmma::load_matrix_sync(
          fb, reinterpret_cast<const bf16*>(&s.b[kk * BS + cf * 16]), BS);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
    tile_skip_up_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ wg,
                        const bf16* __restrict__ wu, bf16* __restrict__ h,
                        int* __restrict__ active, int M, int K, int N, int T,
                        int act, float thr) {
  __shared__ __align__(128) Stage st[NSTAGE];
  __shared__ __align__(128) float s_g[BM * FS];  // act(x @ W_g), this slice
  __shared__ __align__(128) float s_u[BM * FS];  // x @ W_u, this slice
  __shared__ float s_max[BM];      // per-row max of g over this slice
  __shared__ float s_keep[BM];     // 1 where the row keeps the tile
  __shared__ int s_on;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = T / BN;  // slices per tile = blocks per cluster
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tile = col0 / T;
  const int warp = threadIdx.x / 32;
  const int rf = warp & 1, cf = warp >> 1;
  const int nk = K / BK;
  Acc acc;

  mma_loop(st, nk, [&](Stage& s, int kt) {
    load_stage(s, x, K, M, row0, kt * BK, wg, N, kt * BK, col0);
  }, acc, rf, cf);
  wmma::store_matrix_sync(&s_g[(rf * 16) * FS + cf * 16], acc, FS,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN;
    const float v = fmaxf(s_g[r * FS + c], 0.f);
    s_g[r * FS + c] = act ? v * v : v;
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    float m = 0.f;  // g >= 0, so max|g| = max g
    for (int c = 0; c < BN; ++c) m = fmaxf(m, s_g[threadIdx.x * FS + c]);
    s_max[threadIdx.x] = m;
  }
  cluster.sync();  // every slice's row maxima are published
  if (threadIdx.x < BM) {
    float m = 0.f;
    for (int q = 0; q < csize; ++q)
      m = fmaxf(m, cluster.map_shared_rank(s_max, q)[threadIdx.x]);
    s_keep[threadIdx.x] = (row0 + threadIdx.x < M && m > thr) ? 1.f : 0.f;
  }
  cluster.sync();  // no block leaves while another still reads its s_max
  if (threadIdx.x == 0) {
    int on = 0;
    for (int r = 0; r < BM; ++r) on |= s_keep[r] != 0.f;
    s_on = on;
  }
  __syncthreads();
  const bool on = s_on != 0;
  if (on) {
    mma_loop(st, nk, [&](Stage& s, int kt) {
      load_stage(s, x, K, M, row0, kt * BK, wu, N, kt * BK, col0);
    }, acc, rf, cf);
    wmma::store_matrix_sync(&s_u[(rf * 16) * FS + cf * 16], acc, FS,
                            wmma::mem_row_major);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN;
    if (row0 + r < M) {
      const float v = (on && s_keep[r] != 0.f)
                          ? s_u[r * FS + c] * s_g[r * FS + c] : 0.f;
      h[(size_t)(row0 + r) * N + col0 + c] = __float2bfloat16(v);
    }
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0)
    active[blockIdx.x * (N / T) + tile] = on ? 1 : 0;
}

__global__ void __launch_bounds__(NTHREADS)
    tile_skip_down_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ wd,
                          const int* __restrict__ active,
                          float* __restrict__ y, int M, int K, int N, int T) {
  __shared__ __align__(128) Stage st[NSTAGE];
  __shared__ __align__(128) float s_y[BM * FS];
  __shared__ int s_tiles[MAX_TILES];
  __shared__ int s_n;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;  // columns of y (= rows of x's K)
  const int nt = N / T;
  const int warp = threadIdx.x / 32;
  const int rf = warp & 1, cf = warp >> 1;
  if (threadIdx.x == 0) {  // this row block's active tiles, in order
    int n = 0;
    for (int j = 0; j < nt; ++j)
      if (active[blockIdx.x * nt + j]) s_tiles[n++] = j;
    s_n = n;
  }
  __syncthreads();
  const int per_tile = T / BK;
  Acc acc;
  mma_loop(st, s_n * per_tile, [&](Stage& s, int kt) {
    const int n0 = s_tiles[kt / per_tile] * T + (kt % per_tile) * BK;
    load_stage(s, h, N, M, row0, n0, wd, K, n0, col0);
  }, acc, rf, cf);
  wmma::store_matrix_sync(&s_y[(rf * 16) * FS + cf * 16], acc, FS,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN;
    if (row0 + r < M) y[(size_t)(row0 + r) * K + col0 + c] = s_y[r * FS + c];
  }
}

}  // namespace

// x (M, K), wg/wu (K, N), wd (N, K) bf16, row-major contiguous. Outputs:
// y (M, K) float32, h (M, N) bf16, active (ceil(M/32), N/T) int32 (1 where
// the cell ran its W_u/W_d work). Requires K % 32 == 0, T % 32 == 0,
// T <= 256, N % T == 0, N / T <= 1024. act: 0 = relu, 1 = relu^2; thr >= 0.
extern "C" int tile_skip_ffn_bf16(const void* x, const void* wg,
                                  const void* wu, const void* wd, void* y,
                                  void* h, void* active, int M, int K, int N,
                                  int T, int act, float thr, void* stream) {
  const int rb = (M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rb, N / BN, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = T / BN;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, tile_skip_up_kernel, (const bf16*)x, (const bf16*)wg,
      (const bf16*)wu, (bf16*)h, (int*)active, M, K, N, T, act, thr);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(rb, K / BN);
  tile_skip_down_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)wd, (const int*)active, (float*)y, M, K,
      N, T);
  return (int)cudaGetLastError();
}
