// K2h-out: the out-projection and residual of the attention sublayer where
// K2 does not fit (d = 1280, Whisper large-v3): after K5 (LN + QKV) and the
// flash kernel, out = bf16(x + bf16(bf16(attn . wo) + bo)) for attn and x
// bf16 [M, D], wo bf16 [D, D] ([in, out], row-major) and bo bf16 [D].
//
// Replaces the out-projection + residual of the JAX package's
// ops/fused_attention.py::_fused_attn_hsplit_impl (the tail of
// _attn_sublayer_hsplit_kernel). The add order is the module path's and the
// JAX block's long-context route's: the product rounded, + bias, rounded,
// then + x.
//
// What bounds it on the H100: the tensor cores. At M = 24,000 (B=16 x 1500),
// D = 1280 it is 78.6 GFLOP against 184 MB of activations in and out: 0.080
// ms of bf16 products at 989 TFLOP/s against 0.055 ms of bytes.
//
// Design: one 128 x 128 output tile a block (grid D/128 x ceil(M/128); the
// blocks of one row of tiles run together, so each attn row block and all
// of wo are read from L2), the TMA + wgmma mainloop of wgmma_gemm.cuh with
// three 32 KB stages, and two blocks an SM (96 KB of stages each), so one
// block's epilogue overlaps the other's products. The epilogue starts in
// registers (the product rounded to bf16), stages the tile in the freed
// stage memory, and finishes with 16-byte loads of x and bo and 16-byte
// stores of out. Rows past M are read as zeros by the TMA and never stored.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kStages = 3;
constexpr int kLdc = wg::kBN + 8;  // bf16 row pitch of the staged tile

__global__ void __launch_bounds__(wg::kThreads, 2)
out_proj_residual_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
                         const bf16* __restrict__ bo, bf16* __restrict__ out, int M, int D) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const wg::Pipeline<kStages> pipe(smem_raw);
  const int n0 = blockIdx.x * wg::kBN, m0 = blockIdx.y * wg::kBM;
  const int kblocks = D / wg::kBK;
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (threadIdx.x >= wg::kConsumerThreads) {  // the producer warp
    if (threadIdx.x == wg::kConsumerThreads) pipe.produce(&ta, &tw, m0, n0, kblocks);
    return;
  }
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[64];
  pipe.consume(acc, wgi, kblocks);

  // every product of both warpgroups is complete: the stages are free
  wg::consumer_sync();
  fence_proxy_async();
  bf16* cs = reinterpret_cast<bf16*>(pipe.stages);  // [128][kLdc], the rounded product
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = wgi * 64 + wg::acc_row(tid, i), c = wg::acc_col(tid, i);
    *reinterpret_cast<__nv_bfloat162*>(cs + r * kLdc + c) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  wg::consumer_sync();

  constexpr int kVecs = wg::kBN / 8;  // 16-byte vectors a tile row
  for (int v = threadIdx.x; v < wg::kBM * kVecs; v += wg::kConsumerThreads) {
    const int r = v / kVecs, c = (v % kVecs) * 8;
    if (m0 + r >= M) continue;
    const size_t at = (size_t)(m0 + r) * D + n0 + c;
    const uint4 pv = *reinterpret_cast<const uint4*>(cs + r * kLdc + c);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
    const uint4 bv = *reinterpret_cast<const uint4*>(bo + n0 + c);
    const bf16* p = reinterpret_cast<const bf16*>(&pv);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    uint4 ov;
    bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = round_bf16(__bfloat162float(p[e]) + __bfloat162float(be[e]));
      o[e] = __float2bfloat16(__bfloat162float(xe[e]) + y);
    }
    *reinterpret_cast<uint4*>(out + at) = ov;
  }
}

}  // namespace

// attn [M, D] bf16 (the heads' outputs, head-packed), x [M, D] bf16,
// wo [D, D] bf16, bo [D] bf16 -> out [M, D] = x + (bf16(attn . wo) + bo).
// D % 128 == 0; pointers 16-byte aligned.
extern "C" int jl_out_proj_residual(const bf16* attn, const bf16* x, const bf16* wo,
                                    const bf16* bo, bf16* out, int M, int D,
                                    cudaStream_t stream) {
  if (M <= 0 || D <= 0 || D % wg::kBN) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  const uint64_t pitch = (uint64_t)D * sizeof(bf16);
  if (!make_tmap_2d(&ta, attn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, M, pitch, wg::kBK, wg::kBM,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_2d(&tw, wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, D, pitch, 64, wg::kBK,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(kStages);
  cudaError_t err = cudaFuncSetAttribute(out_proj_residual_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / wg::kBN, ceil_div(M, wg::kBM));
  out_proj_residual_kernel<<<grid, wg::kThreads, smem, stream>>>(ta, tw, x, bo, out, M, D);
  return (int)cudaGetLastError();
}
