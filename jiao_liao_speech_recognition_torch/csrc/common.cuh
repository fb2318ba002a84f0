// Helpers shared by the port's hand-written Hopper kernels.
//
// The matrix products use WMMA bf16 16x16x16 tiles with f32 accumulation
// (mma.sync on sm_90a). Activations are staged in shared memory; weight
// fragments are read straight from device memory (they stay hot in L2:
// every weight matrix of the flagship is at most 4.4 MB).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace jl {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps per block in every kernel here
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 bytes)

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// round-to-nearest-even to bf16 and back: the "rounded to bf16" points of
// the JAX kernels
__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// LayerNorm of `rows` rows of x [*, d] (bf16) into a bf16 shared tile
// a[rows][d + kPad], f32 statistics as in ops/fused_*.py::_ln_f32:
// mu = mean(x); xc = x - mu; var = mean(xc^2); (xc / sqrt(var + eps)) * g + b.
// One warp per row; rows at or past `valid` are zero-filled.
__device__ inline void layernorm_rows_to_smem(const bf16* __restrict__ x, int row0,
                                              int rows, int valid, int d,
                                              const float* __restrict__ g,
                                              const float* __restrict__ bl, float eps,
                                              bf16* a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lda = d + kPad;
  for (int r = warp; r < rows; r += kThreads / 32) {
    bf16* arow = a + (size_t)r * lda;
    if (row0 + r >= valid) {
      for (int c = lane; c < d; c += 32) arow[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = x + (size_t)(row0 + r) * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += __bfloat162float(xr[c]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / d;
    float v = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xc = __bfloat162float(xr[c]) - mu;
      v += xc * xc;
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = 1.0f / sqrtf(v / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float xc = __bfloat162float(xr[c]) - mu;
      arow[c] = __float2bfloat16((xc * inv) * g[c] + bl[c]);
    }
  }
}

// copy rows [row0, row0 + rows) x cols [col0, col0 + width) of a row-major
// bf16 matrix (row stride ld) into a shared tile dst[rows][width + kPad];
// rows at or past `valid` are zero-filled. width % 8 == 0, 16-byte aligned.
__device__ inline void load_tile_bf16(const bf16* __restrict__ src, int ld, int row0,
                                      int rows, int valid, int col0, int width,
                                      bf16* dst) {
  const int vecs = width / 8;
  const int ldd = width + kPad;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + v * 8);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + v * 8) = val;
  }
}

}  // namespace jl
