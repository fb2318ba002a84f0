// K4: fused CTC head + argmax, ids[r] = argmax_v (x[r] . W[:, v] + b[v]).
//
// Replaces ops/fused_head.py::fused_head_argmax (_head_argmax_kernel) of
// the JAX package.
//
// What bounds it on the H100: tensor-core work of the head product
// (2 * rows * d * V flops, 107 GFLOP at 32 x 30 s with V = 4336). Unfused,
// the [rows, V] f32 logits (416 MB at that size) would be written and read
// back by a separate argmax; here only ids [rows] int32 leave the kernel.
//
// Design: one block per 64-row tile with the bf16 rows in shared memory;
// the vocabulary is walked in 128-column chunks. A chunk's logits (f32
// accumulation, + f32 bias) go to shared memory, where 4 threads per row
// take the chunk's (max, first index); a running (max, argmax) per row is
// updated only on a strictly greater max, so ties keep the earliest index,
// as jnp.argmax does. Columns at or past V are skipped, so the ragged last
// chunk needs no padding columns.
//
// P2, jl_head_argmax_chunked below: the same function with the 512-column
// vocabulary chunks of the TPU kernel, the A/B probe of
// examples/profile_head_kernel.py (_kernel_fori under its pallas_call, the
// runtime chunk loop). Its note is above its kernel.
#include "common.cuh"

namespace {

using namespace jl;

constexpr int BM = 64;
constexpr int BN = 128;

// x [M, d] bf16, w [d, ldw] bf16 (columns >= V unread or ignored),
// b [V] f32 -> ids [M] i32
__global__ void __launch_bounds__(kThreads)
head_argmax_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ b, int* __restrict__ ids, int M, int d, int V,
                   int ldw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + kPad, ldc = BN + 4;
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* c = reinterpret_cast<float*>(smem + align128((size_t)BM * lda * 2));
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;

  load_tile_bf16(x, d, row0, BM, M, 0, d, a);
  __syncthreads();

  float best = -INFINITY;
  int best_i = 0;
  for (int v0 = 0; v0 < V; v0 += BN) {
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < d; k += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (size_t)(wm * 32 + i * 16) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = v0 + wn * 32 + j * 16;
        if (col >= ldw) continue;  // warp-uniform: fragment wholly past the weights
        FragB fb;
        wmma::load_matrix_sync(fb, w + (size_t)k * ldw + col, ldw);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c + (size_t)(wm * 32 + i * 16) * ldc + wn * 32 + j * 16,
                                acc[i][j], ldc, wmma::mem_row_major);
    __syncthreads();
    // chunk (max, first index) over this thread's 32 columns, ascending
    float m = -INFINITY;
    int mi = 0x7fffffff;
    for (int cc = 0; cc < 32; ++cc) {
      const int col = v0 + part * 32 + cc;
      if (col >= V) break;
      const float val = c[row * ldc + part * 32 + cc] + b[col];
      if (val > m) { m = val; mi = col; }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
      if (om > m || (om == m && oi < mi)) { m = om; mi = oi; }
    }
    if (m > best) { best = m; best_i = mi; }
    __syncthreads();  // c is rewritten by the next chunk
  }
  if (part == 0 && row0 + row < M) ids[row0 + row] = best_i;
}

// P2: head + argmax over 512-column vocabulary chunks.
//
// Replaces examples/profile_head_kernel.py::_kernel_fori, K4's A/B partner
// (the superseded runtime chunk loop of the TPU kernel). It computes K4's
// function: argmax_v(x . W + b) into int32 ids.
//
// What bounds it on the H100: as K4, the head product on the tensor cores
// (2 * rows * d * V flops; 0.108 ms at 32 x 750 rows, d 512, V 4336).
//
// Design: one block per 64-row tile, the bf16 rows in shared memory (66.5
// KB at d 512) beside one chunk's [64][512] f32 logits (132 KB). A chunk's
// 8 warps each hold 2 x 8 accumulator fragments (32 rows x 128 columns).
// Every 16-column fragment is formed as K4 forms it: from zero, k16 steps in
// ascending k, then + b[v] in the scan, so P2's logits are K4's bit for bit
// and its ids equal K4's exactly. Per chunk, 4 threads per row take the
// chunk's (max, first index) over 128 columns each, merged by shuffles; the
// running (max, argmax) of the row changes only on a strictly greater max,
// so ties keep the earliest index. The TPU probe pads W with zero columns
// and b with -1e30 to whole chunks; here columns at or past V are skipped,
// which gives the same ids unless every logit of a row is below -1e30.
constexpr int BN2 = 512;

// x [M, d] bf16, w [d, ldw] bf16 (columns >= V ignored), b [V] f32 -> ids [M] i32
__global__ void __launch_bounds__(kThreads)
head_argmax_chunked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const float* __restrict__ b, int* __restrict__ ids, int M, int d,
                           int V, int ldw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + kPad, ldc = BN2 + 4;
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* c = reinterpret_cast<float*>(smem + align128((size_t)BM * lda * 2));
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;  // 32 rows x 128 columns of the chunk
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;
  constexpr int NJ = BN2 / 4 / 16;  // column fragments per warp

  load_tile_bf16(x, d, row0, BM, M, 0, d, a);
  __syncthreads();

  float best = -INFINITY;
  int best_i = 0;
  for (int v0 = 0; v0 < V; v0 += BN2) {
    FragC acc[2][NJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < d; k += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (size_t)(wm * 32 + i * 16) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = v0 + wn * (BN2 / 4) + j * 16;
        if (col >= ldw) continue;  // warp-uniform: fragment wholly past the weights
        FragB fb;
        wmma::load_matrix_sync(fb, w + (size_t)k * ldw + col, ldw);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wmma::store_matrix_sync(c + (size_t)(wm * 32 + i * 16) * ldc + wn * (BN2 / 4) + j * 16,
                                acc[i][j], ldc, wmma::mem_row_major);
    __syncthreads();
    // chunk (max, first index) over this thread's 128 columns, ascending
    float m = -INFINITY;
    int mi = 0x7fffffff;
    for (int cc = 0; cc < BN2 / 4; ++cc) {
      const int col = v0 + part * (BN2 / 4) + cc;
      if (col >= V) break;
      const float val = c[row * ldc + part * (BN2 / 4) + cc] + b[col];
      if (val > m) { m = val; mi = col; }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
      if (om > m || (om == m && oi < mi)) { m = om; mi = oi; }
    }
    if (m > best) { best = m; best_i = mi; }
    __syncthreads();  // c is rewritten by the next chunk
  }
  if (part == 0 && row0 + row < M) ids[row0 + row] = best_i;
}

}  // namespace

extern "C" int jl_head_argmax(const bf16* x, const bf16* w, const float* b, int* ids, int M,
                              int d, int V, int ldw, cudaStream_t stream) {
  const size_t smem = align128((size_t)BM * (d + kPad) * 2) + (size_t)BM * (BN + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(head_argmax_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_argmax_kernel<<<ceil_div(M, BM), kThreads, smem, stream>>>(x, w, b, ids, M, d, V, ldw);
  return (int)cudaGetLastError();
}

extern "C" int jl_head_argmax_chunked(const bf16* x, const bf16* w, const float* b, int* ids,
                                      int M, int d, int V, int ldw, cudaStream_t stream) {
  const size_t smem = align128((size_t)BM * (d + kPad) * 2) + (size_t)BM * (BN2 + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(head_argmax_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_argmax_chunked_kernel<<<ceil_div(M, BM), kThreads, smem, stream>>>(x, w, b, ids, M, d, V,
                                                                         ldw);
  return (int)cudaGetLastError();
}
