// Helpers shared by the port's hand-written Hopper kernels.
//
// The WMMA kernel (log_mel.cu's P1) takes bf16 16x16x16 tiles with f32
// accumulation (mma.sync on sm_90a): activations staged in shared memory,
// weight fragments read straight from device memory (hot in L2). The TMA +
// wgmma kernels (ln_gemm.cu, head.cu, flash_attention.cu, log_mel_tf32.cu)
// build on wgmma_gemm.cuh.
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

// GELU of an f32 value, the two forms of ops/fused_mlp.py::gelu_f32: the
// tanh form in jax.nn.gelu(approximate=True)'s op order, and the erf form
// through the Abramowitz-Stegun 7.1.26 rational of the JAX kernel's
// _erf_gelu_f32 (|err| <= 1.5e-7)
__device__ inline float gelu_tanh(float h) {
  // op order of jax.nn.gelu(approximate=True): h * (0.5 * (1 + tanh(c (h + a h^3))))
  const float c = 0.7978845608028654f;  // np.float32(np.sqrt(2 / np.pi))
  const float cdf = 0.5f * (1.0f + tanhf(c * (h + 0.044715f * (h * h * h))));
  return h * cdf;
}

__device__ inline float gelu_erf(float h) {
  const float x = h * 0.70710678118654752f;  // np.float32(1 / np.sqrt(2))
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_ax = 1.0f - poly * expf(-ax * ax);
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  return 0.5f * h * (1.0f + sign * erf_ax);
}

}  // namespace jl
