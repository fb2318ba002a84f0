// K5 (LN + q/k/v), K3 (LN + MLP + residual; K3c at d = 1280), K2h-out
// (out-projection + residual) and K2's first and last launches: an f32
// LayerNorm row pass, then TMA + wgmma GEMMs with the bias, GELU and
// residual folded into their epilogues.
//
// Replaces, from the JAX package's ops/fused_mlp.py, _ln_qkv_kernel
// (fused_ln_qkv), _ln_mlp_res_kernel (fused_ln_mlp_residual) and
// _ln_mlp_csplit_kernel (its hidden-chunk split at d = 1280), and from
// ops/fused_attention.py the out-projection + residual that ends
// _attn_sublayer_hsplit_kernel and (K2, around csrc/flash_attention.cu's
// attention core) the LN + q/k/v and the out-projection + residual of
// _attn_sublayer_kernel. The rounding points are the JAX kernels':
// LN in f32 (mean, centred variance, 1 / sqrt, * g + b) rounded to bf16;
// each product accumulated in f32 and rounded to bf16 before its bias; GELU
// in f32 on the bf16 h + b1, rounded to bf16; the residual as
// x + bf16(bf16(acc) + b) (the module path's order; K3c adds x first, a
// one-ulp difference the 2-ulp bar absorbs), and K2's as
// bf16(x + bf16(acc)) + b (the JAX kernel's x + acc.astype(x.dtype) + bo,
// its own epilogue, kAttnResidual). Every one of those points is a
// bf16 tensor, so splitting the sublayer into launches changes no rounding,
// only the order of f32 sums.
//
// What bounds it on the H100: the tensor cores. At the large-v3 encoder's
// M = 24,000 rows (B=16 x 1500), d = 1280, mlp 5120, K3 is 629 GFLOP
// (0.636 ms at 989 TFLOP/s) and K5 236 GFLOP (0.239 ms); the LN pass moves
// 123 MB (0.037 ms at 3.35 TB/s). The TPU kernels keep LN(x) and the hidden
// tensor in VMEM; here both cross device memory (the hidden tensor, 246 MB
// written and read at B=16, ~0.15 ms a layer), which buys each product the
// full TMA + wgmma pipeline of wgmma_gemm.cuh with weight tiles reused
// across rows from L2.
//
// Design, per launch:
//  * ln_rows: one warp a row, 16-byte loads held in registers (d <= 2048),
//    the f32 statistics, 16-byte stores of LN(x) into a bf16 scratch the
//    wrapper allocates;
//  * gemm_kernel<EPI, ENTRY>: one 128 x 128 output tile a block (grid
//    N / 128 x ceil(M / 128); the blocks of one row of tiles run together,
//    so each A row block comes from L2 and the weights stay there), a
//    producer warp feeding three TMA stages, two consumer warpgroups on
//    wgmma, two blocks an SM so one block's epilogue overlaps the other's
//    products. The epilogue starts in registers on the accumulator layout
//    (the product rounded; fc1 adds b1 and takes the GELU there), stages
//    the bf16 tile in the freed stage memory, and finishes with 16-byte
//    vectors: + bias (K5), a copy (fc1), + bias then + x (fc2 and K2h-out,
//    one code path), + x then + bias (K2). Rows past M are read as zeros
//    by the TMA and never stored. No split-K, no atomics: two launches give
//    the same bits.
// K5 is ln_rows + gemm<kBias> (N = 3D); K3 is ln_rows + gemm<kGelu*> (N =
// mlp, into a hidden scratch) + gemm<kResidual> (K = mlp); K2h-out is
// gemm<kResidual, kOutProj> alone; K2 is K5's two launches, the attention
// core, then gemm<kAttnResidual, kAttnOut>.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kBN = wg::kBN;
constexpr int kStages = 3;
constexpr int kBlocksPerSM = 2;
constexpr int kLdc = kBN + 8;  // bf16 row pitch of the staged tile

constexpr int kLnWarps = 8;    // rows per ln_rows block
constexpr int kLnMaxVecs = 8;  // 16-byte vectors a lane holds: d <= 8 x 32 x 8

enum Epilogue { kBias, kGeluTanh, kGeluErf, kResidual, kAttnResidual };
// The C entry point an instance serves. It changes no code: K3's fc2 and
// K2h-out run the same epilogue, and a profile tells them apart only by the
// kernel's name (gemm_kernel<3, 0> against gemm_kernel<3, 1>; K2's
// out-projection is gemm_kernel<4, 2>; ln_rows_kernel<0> serves K5 and K2,
// ln_rows_kernel<1> K3).
enum Entry { kSublayer, kOutProj, kAttnOut };

// x [M, d] bf16, g / bl [d] f32 -> ln [M, d] bf16. d % 8 == 0, d <= 2048.
// ENTRY names the instance only: 0 before a q/k/v product, 1 before fc1.
template <int ENTRY>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ bl, bf16* __restrict__ ln, int M, int d, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int nv = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  uint4 xv[kLnMaxVecs];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVecs; ++i) {
    if (lane + 32 * i >= nv) break;
    xv[i] = xr[lane + 32 * i];
    const bf16* e = reinterpret_cast<const bf16*>(&xv[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / d;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVecs; ++i) {
    if (lane + 32 * i >= nv) break;
    const bf16* e = reinterpret_cast<const bf16*>(&xv[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xc = __bfloat162float(e[j]) - mu;
      v += xc * xc;
    }
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float inv = 1.0f / sqrtf(v / d + eps);
  uint4* lr = reinterpret_cast<uint4*>(ln + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < kLnMaxVecs; ++i) {
    const int c = lane + 32 * i;
    if (c >= nv) break;
    const bf16* e = reinterpret_cast<const bf16*>(&xv[i]);
    const float4 g0 = reinterpret_cast<const float4*>(g)[2 * c];
    const float4 g1 = reinterpret_cast<const float4*>(g)[2 * c + 1];
    const float4 b0 = reinterpret_cast<const float4*>(bl)[2 * c];
    const float4 b1 = reinterpret_cast<const float4*>(bl)[2 * c + 1];
    const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 ov;
    bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __float2bfloat16(((__bfloat162float(e[j]) - mu) * inv) * gs[j] + bs[j]);
    lr[c] = ov;
  }
}

// out [M, N] = epilogue(a [M, K] . w [K, N]) for bf16 a, w (row-major, w
// as [in, out]), bias [N] bf16, res [M, N] bf16 (kResidual and
// kAttnResidual only)
template <int EPI, int ENTRY>
__global__ void __launch_bounds__(wg::kThreads, kBlocksPerSM)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
            const bf16* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const wg::Pipeline<kStages> pipe(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * wg::kBM;
  const int kblocks = K / wg::kBK;
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (threadIdx.x >= wg::kConsumerThreads) {  // the producer warp
    if (threadIdx.x == wg::kConsumerThreads) pipe.produce(&ta, &tw, m0, n0, kblocks);
    return;
  }
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[kBN / 2];
  pipe.consume(acc, wgi, kblocks);

  // every product of both warpgroups is complete: the stages are free
  wg::consumer_sync();
  fence_proxy_async();
  bf16* cs = reinterpret_cast<bf16*>(pipe.stages);  // [128][kLdc]
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    const int r = wgi * 64 + wg::acc_row(tid, i), c = wg::acc_col(tid, i);
    float v0 = round_bf16(acc[i]), v1 = round_bf16(acc[i + 1]);
    if constexpr (EPI == kGeluTanh || EPI == kGeluErf) {
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c));
      v0 = round_bf16(v0 + b.x);
      v1 = round_bf16(v1 + b.y);
      v0 = EPI == kGeluErf ? gelu_erf(v0) : gelu_tanh(v0);
      v1 = EPI == kGeluErf ? gelu_erf(v1) : gelu_tanh(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(cs + r * kLdc + c) = __floats2bfloat162_rn(v0, v1);
  }
  wg::consumer_sync();

  constexpr int kVecs = kBN / 8;  // 16-byte vectors a tile row
  for (int v = threadIdx.x; v < wg::kBM * kVecs; v += wg::kConsumerThreads) {
    const int r = v / kVecs, c = (v % kVecs) * 8;
    if (m0 + r >= M) continue;
    const size_t at = (size_t)(m0 + r) * N + n0 + c;
    uint4 ov = *reinterpret_cast<const uint4*>(cs + r * kLdc + c);
    if constexpr (EPI == kBias || EPI == kResidual || EPI == kAttnResidual) {
      const uint4 bv = *reinterpret_cast<const uint4*>(bias + n0 + c);
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (EPI != kBias) xv = *reinterpret_cast<const uint4*>(res + at);
      bf16* o = reinterpret_cast<bf16*>(&ov);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = __bfloat162float(o[e]), bb = __bfloat162float(be[e]);
        const float xx = __bfloat162float(xe[e]);
        float y;
        if constexpr (EPI == kAttnResidual) y = round_bf16(xx + a) + bb;
        else if constexpr (EPI == kResidual) y = xx + round_bf16(a + bb);
        else y = a + bb;
        o[e] = __float2bfloat16(y);
      }
    }
    *reinterpret_cast<uint4*>(out + at) = ov;
  }
}

template <int ENTRY>
int ln_rows(const bf16* x, const float* g, const float* bl, bf16* ln, int M, int d, float eps,
            cudaStream_t stream) {
  if (M <= 0 || d <= 0 || d % 8 || d > kLnMaxVecs * 32 * 8) return (int)cudaErrorInvalidValue;
  ln_rows_kernel<ENTRY><<<ceil_div(M, kLnWarps), kLnWarps * 32, 0, stream>>>(x, g, bl, ln, M, d,
                                                                             eps);
  return (int)cudaGetLastError();
}

template <int EPI, int ENTRY = kSublayer>
int gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* res, bf16* out, int M,
         int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN || K % wg::kBK) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  if (!make_tmap_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, (uint64_t)K * sizeof(bf16),
                    wg::kBK, wg::kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, (uint64_t)N * sizeof(bf16),
                    64, wg::kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(kStages);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI, ENTRY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN, ceil_div(M, wg::kBM));
  gemm_kernel<EPI, ENTRY><<<grid, wg::kThreads, smem, stream>>>(ta, tw, bias, res, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: x [M, d] bf16, g / bl [d] f32, w [d, N] bf16 ([Wq | Wk | Wv]), bias
// [N] bf16 -> out [M, N] = bf16(bf16(LN(x) . w) + bias), with ln [M, d]
// bf16 as scratch. d % 64 == 0, d <= 2048, N % 128 == 0; pointers 16-byte
// aligned.
extern "C" int jl_ln_qkv(const bf16* x, const float* g, const float* bl, const bf16* w,
                         const bf16* bias, bf16* ln, bf16* out, int M, int d, int N, float eps,
                         cudaStream_t stream) {
  const int err = ln_rows<0>(x, g, bl, ln, M, d, eps, stream);
  return err ? err : gemm<kBias>(ln, w, bias, nullptr, out, M, N, d, stream);
}

// K3: x [M, d] bf16, g / bl [d] f32, w1 [d, mlp], b1 [mlp], w2 [mlp, d],
// b2 [d] bf16 -> out [M, d] = x + bf16(bf16(h . w2) + b2) for
// h = bf16(GELU(bf16(bf16(LN(x) . w1) + b1))) (erf_form: the erf rational,
// else tanh), with ln [M, d] and h [M, mlp] bf16 as scratch. d and mlp
// % 128 == 0, d <= 2048; pointers 16-byte aligned.
extern "C" int jl_ln_mlp_residual(const bf16* x, const float* g, const float* bl,
                                  const bf16* w1, const bf16* b1, const bf16* w2,
                                  const bf16* b2, bf16* ln, bf16* h, bf16* out, int M, int d,
                                  int mlp, int erf_form, float eps, cudaStream_t stream) {
  int err = ln_rows<1>(x, g, bl, ln, M, d, eps, stream);
  if (!err)
    err = erf_form ? gemm<kGeluErf>(ln, w1, b1, nullptr, h, M, mlp, d, stream)
                   : gemm<kGeluTanh>(ln, w1, b1, nullptr, h, M, mlp, d, stream);
  return err ? err : gemm<kResidual>(h, w2, b2, x, out, M, d, mlp, stream);
}

// K2h-out: attn [M, D] bf16 (the heads' outputs, head-packed), x [M, D]
// bf16, wo [D, D] bf16, bo [D] bf16 -> out [M, D] = x + bf16(bf16(attn .
// wo) + bo). D % 128 == 0; pointers 16-byte aligned.
extern "C" int jl_out_proj_residual(const bf16* attn, const bf16* x, const bf16* wo,
                                    const bf16* bo, bf16* out, int M, int D,
                                    cudaStream_t stream) {
  return gemm<kResidual, kOutProj>(attn, wo, bo, x, out, M, D, D, stream);
}

// K2's out-projection: attn [M, D] bf16 (csrc/flash_attention.cu's core
// output), x [M, D] bf16, wo [D, D] bf16, bo [D] bf16 -> out [M, D] =
// bf16(bf16(x + bf16(attn . wo)) + bo), the JAX kernel's order. D % 128 ==
// 0; pointers 16-byte aligned.
extern "C" int jl_attn_out_proj(const bf16* attn, const bf16* x, const bf16* wo, const bf16* bo,
                                bf16* out, int M, int D, cudaStream_t stream) {
  return gemm<kAttnResidual, kAttnOut>(attn, wo, bo, x, out, M, D, D, stream);
}
