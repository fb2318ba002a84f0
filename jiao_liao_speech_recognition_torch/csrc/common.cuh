// Helpers shared by the port's hand-written Hopper kernels. The TMA +
// wgmma kernels (ln_gemm.cu, head.cu, flash_attention.cu, log_mel_tf32.cu,
// w8a8_mlp.cu) build on wgmma_gemm.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jl {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps a block (decode_attention.cu, quant.cu)
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 bytes)

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the current device's SM count, asked once a device (the persistent
// GEMMs' grid)
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// int8 -> f32 without an integer-to-float conversion (I2F issues at 16 a
// clock an SM on sm_90, an eighth of the FP32 rate): the sign-flipped byte
// u = b + 128 is put in the low mantissa bits of 2^23 (bits 0x4B0000uu are
// the float 2^23 + u), and 2^23 + 128 is subtracted. Both steps are exact
// for every int8 value. f[i] is byte i of w.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

// int8 -> bf16, exact, as two bf16x2 words (.x: bytes 0, 1; .y: bytes 2, 3;
// the lower byte in the lower half): the high halves of int8x4_to_f32's
// values, whose low 16 bits are zero (|b| <= 128 needs 8 significant bits)
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  float f[4];
  int8x4_to_f32(w, f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

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

// K3's GELU as a table of its bf16 bits: its input is a bf16 value (GELU is
// applied to bf16(h + b1)), so for the 2 x 28 x 128 inputs with 2^-24 <= |h|
// < 16 the table holds the form's own bf16 result, and outside that range
// the result is exact by rule: |h| < 2^-24 gives bf16(0.5 h) (1 + tanh(u)
// and 1 + erf(x) round to 1 or next to it), |h| >= 16 gives h or -0 (tanh
// and erf round to +-1), +inf gives +inf, -inf and NaN give NaN. So a
// lookup gives the form's bits, and chip_smoke.py checks all 65,536 inputs.
constexpr int kGeluE0 = 127 - 24;                          // smallest exponent in the table
constexpr int kGeluE1 = 127 + 4;                           // past the largest
constexpr int kGeluSpan = (kGeluE1 - kGeluE0) * 128;       // entries of one sign
constexpr uint32_t kGeluTableBytes = 2 * kGeluSpan * 2;    // both signs, bf16

// the table of gelu_tanh (erf = 0) or gelu_erf (erf = 1), filled by
// `threads` threads from `tid`
__device__ __forceinline__ void gelu_table_fill(uint16_t* table, int erf, int tid, int threads) {
  for (int i = tid; i < 2 * kGeluSpan; i += threads) {
    const int sign = i / kGeluSpan, r = i % kGeluSpan;
    const uint16_t bits = (uint16_t)((sign << 15) | ((kGeluE0 + r / 128) << 7) | (r % 128));
    const float h = __bfloat162float(__ushort_as_bfloat16(bits));
    table[i] = __bfloat16_as_ushort(__float2bfloat16(erf ? gelu_erf(h) : gelu_tanh(h)));
  }
}

// the GELU's bf16 bits for the bf16 input with bits `b`. Selects only, and
// a load from the table for every input (at a clamped index): branches per
// element would leave each lookup's latency exposed (an epilogue takes
// 128 a thread a tile)
__device__ __forceinline__ uint16_t gelu_lookup(const uint16_t* table, uint32_t b) {
  const uint32_t sign = b >> 15, e = (b >> 7) & 0xFFu, m = b & 0x7Fu;
  const uint32_t ec = e < (uint32_t)kGeluE0 ? (uint32_t)kGeluE0
                      : e >= (uint32_t)kGeluE1 ? (uint32_t)kGeluE1 - 1 : e;
  const uint16_t looked = table[sign * kGeluSpan + (ec - kGeluE0) * 128 + m];
  const uint16_t tiny = __bfloat16_as_ushort(
      __float2bfloat16(__bfloat162float(__ushort_as_bfloat16((uint16_t)b)) * 0.5f));
  const uint16_t big = (sign == 0 && (e != 0xFFu || m == 0)) ? (uint16_t)b  // h, or +inf
                       : e == 0xFFu ? (uint16_t)0x7FFF : (uint16_t)0x8000;  // NaN, or -0
  return e < (uint32_t)kGeluE0 ? tiny : e >= (uint32_t)kGeluE1 ? big : looked;
}

}  // namespace jl
