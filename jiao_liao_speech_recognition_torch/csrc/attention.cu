// K2: fused self-attention sublayer, y = x + Wo . MHA(LN(x)) + bo.
//
// Replaces ops/fused_attention.py::fused_attention_sublayer of the JAX
// package (_ln_kv_kernel + _attn_sublayer_kernel, and the head-group-split
// twins _ln_kv_hsplit_kernel + _attn_sublayer_hsplit_kernel for dh | 128):
// the head width is a template parameter here (dh = 64 or 128), so one
// kernel covers both.
//
// What bounds it on the H100: at T' = 750 the sublayer is a chain of small
// matrix products (the q/k/v and out projections, 4 heads of 750 x 750
// scores) - tensor-core work with little reuse per block. The TPU kernel
// kept all keys resident in VMEM; here K and V of one head at T' = 750 are
// ~375 KB, over the 227 KB of shared memory a block may use.
//
// Design, two launches:
//  1. jl_ln_qkv (ln_gemm.cu, K5's launches): LN in f32, then one product
//     against [Wq | Wk | Wv] -> qkv [rows, 3D] bf16. Each projection is
//     rounded to bf16 before its bias is added (k has no bias, passed as
//     zeros), as in the JAX kernel. q goes to device memory too: on the
//     card one wide product beats recomputing LN and q per query tile, and
//     q is 1/3 of the tensor k and v already write.
//  2. jl_attention_out: one block per (64-query tile, utterance). Per head,
//     the keys are walked in 64-key tiles twice: pass 1 gathers the row max
//     and the row sum of exp(s - max); pass 2 recomputes the same scores,
//     forms p = exp(s - max) / sum, rounds p to bf16 and accumulates P.V in
//     f32. That reproduces the reference's rounding point (p normalised,
//     then cast, before P.V). Keys at or past kv_lengths[b] get
//     finfo(f32).min, so a zero-length row averages uniformly instead of
//     giving NaN; key slots past T get -inf (they do not exist in the
//     reference). The bf16 head outputs of all heads stay in shared memory
//     and go through one out-projection product, then + x, then + bo.
// Where launch 2 does not fit (d = 1280), jl_ln_qkv is K5 and the flash
// kernel takes the attention; jl_out_proj_residual (ln_gemm.cu) then does
// the out-projection and the residual.
#include "common.cuh"

#include <float.h>

namespace {

using namespace jl;

constexpr int BM = 64;   // query rows per block
constexpr int BN = 128;  // output columns per product pass
constexpr int BK = 64;   // keys per tile

// 64 x 128 output tile = 2 x 4 warps of 32 x 32 (2 x 2 fragments) each:
// acc += a_smem[64][lda] (K columns) x w[k][n0 .. n0 + 128) (row stride ldw)
__device__ inline void tile_64x128(const bf16* a, int lda, const bf16* __restrict__ w,
                                   int ldw, int n0, int K, FragC (&acc)[2][2]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k = 0; k < K; k += 16) {
    FragA fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], a + (size_t)(wm * 32 + i * 16) * lda + k, lda);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], w + (size_t)k * ldw + n0 + wn * 32 + j * 16, ldw);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

__device__ inline void store_64x128(float* c, int ldc, FragC (&acc)[2][2]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + (size_t)(wm * 32 + i * 16) * ldc + wn * 32 + j * 16,
                              acc[i][j], ldc, wmma::mem_row_major);
}

// qkv [B*T, 3D] bf16 (q | k | v), lens [B] i32, x [B*T, D] bf16,
// wo [D, D] bf16, bo [D] bf16 -> out [B*T, D] bf16
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_out_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lens,
                     const bf16* __restrict__ x, const bf16* __restrict__ wo,
                     const bf16* __restrict__ bo, bf16* __restrict__ out, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldh = DH + kPad;    // q/k/v tiles
  constexpr int lds = BK + 4;       // f32 scores
  constexpr int ldp = BK + kPad;    // bf16 probabilities
  constexpr int NJ = DH / 32;       // P.V column fragments per warp
  const int D = H * DH, ld3 = 3 * D, ldo = D + kPad, ldc = BN + 4;
  size_t off = 0;
  bf16* qs = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BM * ldh * 2);
  bf16* ks = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BK * ldh * 2);
  bf16* vs = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BK * ldh * 2);
  float* s = reinterpret_cast<float*>(smem + off); off += align128((size_t)BM * lds * 4);
  bf16* p = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BM * ldp * 2);
  bf16* os = reinterpret_cast<bf16*>(smem + off); off += align128((size_t)BM * ldo * 2);
  float* c = reinterpret_cast<float*>(smem + off);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int len = min(lens[b], T);
  const bf16* base = qkv + (size_t)b * T * ld3;
  const float scale = (float)(1.0 / sqrt((double)DH));  // np.float32(1 / np.sqrt(dh))
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps over 64 x 64 scores
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;  // 4 threads per row
  const int n_tiles = ceil_div(T, BK);

  for (int h = 0; h < H; ++h) {
    load_tile_bf16(base, ld3, q0, BM, T, h * DH, DH, qs);

    // scores of one key tile -> s[64][64], scaled and masked in place
    auto scores = [&](int k0) {
      FragC acc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int k = 0; k < DH; k += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, qs + (size_t)(wm * 16) * ldh + k, ldh);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBT fb;  // K^T: column n of the fragment is key row n
          wmma::load_matrix_sync(fb, ks + (size_t)(wn * 32 + j * 16) * ldh + k, ldh);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(s + (size_t)(wm * 16) * lds + wn * 32 + j * 16, acc[j], lds,
                                wmma::mem_row_major);
      __syncthreads();
      for (int cc = 0; cc < 16; ++cc) {
        const int col = part * 16 + cc, key = k0 + col;
        float v = s[row * lds + col] * scale;
        if (key >= T) v = -INFINITY;
        else if (key >= len) v = -FLT_MAX;
        s[row * lds + col] = v;
      }
      // each row is owned by its 4 threads from here: no barrier needed
    };

    // pass 1: row max and row sum of exp(s - max), online over key tiles
    float m = -INFINITY, l = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();  // previous readers of ks / s are done
      load_tile_bf16(base, ld3, t * BK, BK, T, D + h * DH, DH, ks);
      __syncthreads();
      scores(t * BK);
      float mt = -INFINITY;
      for (int cc = 0; cc < 16; ++cc) mt = fmaxf(mt, s[row * lds + part * 16 + cc]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m, mt);
      float sum = 0.f;
      for (int cc = 0; cc < 16; ++cc) sum += expf(s[row * lds + part * 16 + cc] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l = l * expf(m - mn) + sum;
      m = mn;
    }

    // pass 2: normalised bf16 probabilities times V, f32 accumulation
    FragC o[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(o[j], 0.f);
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();
      load_tile_bf16(base, ld3, t * BK, BK, T, D + h * DH, DH, ks);
      load_tile_bf16(base, ld3, t * BK, BK, T, 2 * D + h * DH, DH, vs);
      __syncthreads();
      scores(t * BK);
      for (int cc = 0; cc < 16; ++cc) {
        const int col = part * 16 + cc;
        p[row * ldp + col] = __float2bfloat16(expf(s[row * lds + col] - m) / l);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; k += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, p + (size_t)(wm * 16) * ldp + k, ldp);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, vs + (size_t)k * ldh + (wn * NJ + j) * 16, ldh);
          wmma::mma_sync(o[j], fa, fb, o[j]);
        }
      }
    }
    // head output, rounded to bf16, into its column block of os
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wmma::store_matrix_sync(c + (size_t)(wm * 16) * ldc + (wn * NJ + j) * 16, o[j], ldc,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * DH; i += kThreads) {
      const int r = i / DH, col = i % DH;
      os[r * ldo + h * DH + col] = __float2bfloat16(c[r * ldc + col]);
    }
    __syncthreads();
  }

  // out projection over all heads, then y = (x + bf16(acc)) + bo
  for (int n0 = 0; n0 < D; n0 += BN) {
    FragC acc[2][2];
    tile_64x128(os, ldo, wo, D, n0, D, acc);
    store_64x128(c, ldc, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, col = i % BN;
      if (q0 + r < T) {
        const size_t at = ((size_t)b * T + q0 + r) * D + n0 + col;
        const float y = round_bf16(__bfloat162float(x[at]) + round_bf16(c[r * ldc + col]));
        out[at] = __float2bfloat16(y + __bfloat162float(bo[n0 + col]));
      }
    }
    __syncthreads();
  }
}

template <int DH>
int launch_attention_out(const bf16* qkv, const int* lens, const bf16* x, const bf16* wo,
                         const bf16* bo, bf16* out, int B, int T, int H,
                         cudaStream_t stream) {
  const int D = H * DH;
  const size_t smem = align128((size_t)BM * (DH + kPad) * 2) +
                      2 * align128((size_t)BK * (DH + kPad) * 2) +
                      align128((size_t)BM * (BK + 4) * 4) +
                      align128((size_t)BM * (BK + kPad) * 2) +
                      align128((size_t)BM * (D + kPad) * 2) + (size_t)BM * (BN + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(attention_out_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ceil_div(T, BM), B);
  attention_out_kernel<DH><<<grid, kThreads, smem, stream>>>(qkv, lens, x, wo, bo, out, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jl_attention_out(const bf16* qkv, const int* lens, const bf16* x,
                                const bf16* wo, const bf16* bo, bf16* out, int B, int T,
                                int H, int dh, cudaStream_t stream) {
  if (dh == 128) return launch_attention_out<128>(qkv, lens, x, wo, bo, out, B, T, H, stream);
  if (dh == 64) return launch_attention_out<64>(qkv, lens, x, wo, bo, out, B, T, H, stream);
  return (int)cudaErrorInvalidValue;
}
