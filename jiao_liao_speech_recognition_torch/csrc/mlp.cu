// K3: fused LN + MLP + residual, y = x + (GELU(LN(x) W1 + b1) W2 + b2).
//
// Replaces ops/fused_mlp.py::fused_ln_mlp_residual of the JAX package
// (_ln_mlp_res_kernel; the hidden-chunk split of _ln_mlp_csplit_kernel is
// how this kernel always works).
//
// What bounds it on the H100: tensor-core work, 4 * rows * d * mlp flops
// (100 GFLOP per flagship layer at 32 x 30 s). Unfused, the [rows, mlp]
// hidden tensor would cross device memory twice (fc1 out, fc2 in) - 4x the
// bytes of x - plus the LN output; here only x is read and y written.
//
// Design: one block per 32-row tile. LN runs in f32 into a bf16 tile in
// shared memory. The hidden axis is walked in 128-wide chunks: fc1 of the
// chunk (f32 accumulation) -> round to bf16 -> + b1 -> GELU in f32 ->
// bf16 -> accumulate the chunk's fc2 product in f32 registers, so neither
// LN(x) nor the hidden state reaches device memory. The end rounds to bf16,
// adds b2, then the residual, the order of the JAX kernel. GELU is the tanh
// form or the Abramowitz-Stegun 7.1.26 erf rational of _erf_gelu_f32.
//
// d = 1280 (Whisper large-v3, mlp 5120, erf: the TPU's K3c,
// ops/fused_mlp.py::_fused_ln_mlp_csplit_impl): the f32 accumulator tile
// [32][D] no longer fits beside the LN tile (272 KB at D = 1280), so the
// accumulators leave their registers through the LN tile's shared memory,
// which is free after the last chunk, 16 rows at a time: every width now
// needs 64 D + 26 KB of shared memory (108 KB at 1280). The add order stays
// bf16(acc) + b2, then + x (the module path's); K3c adds x first, a one-ulp
// difference the 2-ulp bar absorbs. At 1280 each thread holds 20
// accumulator fragments (160 f32 registers).
#include "common.cuh"

namespace {

using namespace jl;

constexpr int BM = 32;   // rows per block
constexpr int HC = 128;  // hidden columns per chunk

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

// x [M, D] bf16, g/bl [D] f32, w1 [D, mlp] bf16, b1 [mlp] bf16,
// w2 [mlp, D] bf16, b2 [D] bf16 -> out [M, D] bf16
template <int D>
__global__ void __launch_bounds__(kThreads)
ln_mlp_residual_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ bl, const bf16* __restrict__ w1,
                       const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                       const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int mlp,
                       int erf_form, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int lda = D + kPad, ldh = HC + kPad, ldc = HC + 4, ldy = D + 4;
  static_assert(16 * ldy * 4 <= BM * lda * 2, "16 f32 rows must fit the LN tile");
  constexpr int NY = D / 128;  // fc2 column fragments per warp (8 warps x NY x 16 = D)
  size_t off = 0;
  bf16* a = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BM * lda * 2);
  bf16* hs = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BM * ldh * 2);
  float* c = reinterpret_cast<float*>(smem + off);
  float* ys = reinterpret_cast<float*>(a);  // [16][ldy] f32, after the last chunk

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  layernorm_rows_to_smem(x, row0, BM, M, D, g, bl, eps, a);

  FragC y[2][NY];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NY; ++j) wmma::fill_fragment(y[i][j], 0.f);
  __syncthreads();

  for (int h0 = 0; h0 < mlp; h0 += HC) {
    // fc1 chunk: 32 x 128 = 2 x 8 fragments, warp -> (row frag warp/4, 2 cols)
    {
      const int fm = warp / 4, fn = (warp % 4) * 2;
      FragC acc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int k = 0; k < D; k += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + (size_t)(fm * 16) * lda + k, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, w1 + (size_t)k * mlp + h0 + (fn + j) * 16, mlp);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c + (size_t)(fm * 16) * ldc + (fn + j) * 16, acc[j], ldc,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HC; i += kThreads) {
      const int r = i / HC, col = i % HC;
      const float hv = round_bf16(round_bf16(c[r * ldc + col]) + __bfloat162float(b1[h0 + col]));
      hs[r * ldh + col] = __float2bfloat16(erf_form ? gelu_erf(hv) : gelu_tanh(hv));
    }
    __syncthreads();
    // fc2 chunk: y[32 x D] += hs[32 x 128] . w2[h0 .. h0 + 128, :]
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], hs + (size_t)(i * 16) * ldh + k, ldh);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, w2 + (size_t)(h0 + k) * D + (warp * NY + j) * 16, D);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(y[i][j], fa[i], fb, y[i][j]);
      }
    }
    __syncthreads();  // hs and c are rewritten by the next chunk
  }

  // epilogue, 16 rows at a time through the LN tile (every chunk is done)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NY; ++j)
      wmma::store_matrix_sync(ys + (warp * NY + j) * 16, y[i][j], ldy, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < 16 * D; e += kThreads) {
      const int r = e / D, col = e % D, row = row0 + i * 16 + r;
      if (row < M) {
        const size_t at = (size_t)row * D + col;
        const float yv = round_bf16(round_bf16(ys[r * ldy + col]) + __bfloat162float(b2[col]));
        out[at] = __float2bfloat16(__bfloat162float(x[at]) + yv);
      }
    }
    __syncthreads();
  }
}

template <int D>
int launch(const bf16* x, const float* g, const float* bl, const bf16* w1, const bf16* b1,
           const bf16* w2, const bf16* b2, bf16* out, int M, int mlp, int erf_form, float eps,
           cudaStream_t stream) {
  const size_t smem = align128((size_t)BM * (D + kPad) * 2) +
                      align128((size_t)BM * (HC + kPad) * 2) + (size_t)BM * (HC + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_residual_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_residual_kernel<D><<<ceil_div(M, BM), kThreads, smem, stream>>>(
      x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jl_ln_mlp_residual(const bf16* x, const float* g, const float* bl,
                                  const bf16* w1, const bf16* b1, const bf16* w2,
                                  const bf16* b2, bf16* out, int M, int d, int mlp,
                                  int erf_form, float eps, cudaStream_t stream) {
  switch (d) {
    case 256: return launch<256>(x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps, stream);
    case 512: return launch<512>(x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps, stream);
    case 768: return launch<768>(x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps, stream);
    case 1024: return launch<1024>(x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps, stream);
    case 1280: return launch<1280>(x, g, bl, w1, b1, w2, b2, out, M, mlp, erf_form, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
