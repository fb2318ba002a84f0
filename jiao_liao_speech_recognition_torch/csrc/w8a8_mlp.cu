// P4: W8A8 LN + MLP + residual on the int8 tensor cores,
// y = x + bf16(dq(fc2 . q(GELU(dq(fc1 . q(LN(x))) + b1))) + b2).
//
// Replaces the A/B probe kernel of examples/profile_w8a8_mlp.py
// (w8a8_kernel under its pallas_call), K3's int8 partner. No serving path
// calls it: it measures what int8 products would buy K3 on this card.
//
// Numerics, in the probe's order: LN in f32; a per-row scale
// a_s = amax|ln| / 127 and codes clip(rint(ln / safe), +-127) with
// safe = a_s or 1 where a_s is 0; fc1 as an exact int32 product;
// h = f32(acc) * (a_s * s1) + b1; tanh (or erf) GELU in f32;
// h_s = amax|h| / 127 over the whole hidden row, codes as before; fc2 as an
// int32 product; y = f32(acc2) * (h_s * s2) + b2; out = x + bf16(y). The
// code divides by the safe scale (never by a reciprocal's product), rounds
// half to even (rintf), and writes every scale step with __fmul_rn /
// __fadd_rn / __fdiv_rn, so nvcc forms no FMA that XLA and PyTorch do not
// form: the int8 codes then equal the plain version's.
//
// What bounds it on the H100: int8 tensor-core work, 4 * rows * d * mlp
// operations (100.7 G at 32 x 750 rows, d 512, mlp 2048: 0.051 ms at 1,979
// TOPS); the bytes (x in, y out, 2 MB of int8 weights) take 0.015 ms.
//
// Design. The second scale spans all of mlp, so fc2 cannot start on a
// hidden chunk before fc1 has finished the row (K3 streams its hidden
// chunks; this kernel cannot). Of the two ways out - 16-row tiles, or fc1
// run twice (once for the amax, once to quantize) - this kernel takes the
// first: one block per 16-row tile keeps the whole f32 hidden tile in
// shared memory (16 x 2048 x 4 = 128 KB) beside its int8 codes (33 KB) and
// the int8 LN tile (9 KB), 171 KB at d 512 / mlp 2048, one block per SM.
// The launch returns an error, and the wrapper raises, where that does not
// fit: d or mlp not a multiple of 512, d > mlp, or tiles over the
// shared-memory limit (cudaFuncSetAttribute refuses them).
// The products are mma.sync.m16n8k32 s8 x s8 -> s32; each of the 8 warps
// owns an eighth of fc1's columns and then of fc2's, 64 at a time. The
// weights come transposed ([n][k], k contiguous: mma's "col" B operand),
// so a lane loads 16 bytes of one weight column and uses them as the B
// fragments of two k32 steps; the A rows are read with the same
// permutation of k inside each 64-wide k block, which leaves the exact
// integer sums unchanged. int8 rows are padded by 64 bytes, so the eight
// rows of a 16-byte fragment load fall in different banks. Rows past M
// are zero and are not written.
#include "common.cuh"

namespace {

using namespace jl;

constexpr int BM = 16;    // rows per block: one m16 tile
constexpr int NP = 64;    // output columns of one warp pass (8 n8 tiles)
constexpr int KB = 64;    // k block: two m16n8k32 steps from one 16-byte load
constexpr int kWarps = kThreads / 32;
constexpr int kPadQ = 64;  // int8 row padding (bytes)
constexpr int kPadH = 8;   // f32 row padding of the hidden tile

__device__ inline void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// clip(rint(v / safe), -127, 127), safe = s where s > 0, else 1
__device__ inline int quant(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s > 0.f ? s : 1.f));
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// the op order of ops/fused_mlp.gelu_f32 (jax.nn.gelu(approximate=True))
__device__ inline float gelu_tanh_rn(float h) {
  const float h3 = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
  return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// the Abramowitz-Stegun 7.1.26 rational of ops/fused_mlp.gelu_f32
__device__ inline float gelu_erf_rn(float h) {
  const float x = __fmul_rn(h, 0.70710678118654752f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fmul_rn(t, __fadd_rn(0.254829592f, __fmul_rn(t, p)));
  const float erf_ax = __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-ax, ax))));
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, __fmul_rn(sign, erf_ax)));
}

// acc[j] += rows (gid, gid + 8) of a [16][K] int8 (row stride lda) times
// columns n0 + 8 j + gid of wt [N][K] int8, for j < NP / 8, over all K
__device__ inline void product_pass(const int8_t* a, int lda, const int8_t* __restrict__ wt,
                                    int K, int n0, int (&acc)[NP / 8][4]) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int k0 = 0; k0 < K; k0 += KB) {
    const uint4 lo = *reinterpret_cast<const uint4*>(a + (size_t)gid * lda + k0 + tig * 16);
    const uint4 hi = *reinterpret_cast<const uint4*>(a + (size_t)(gid + 8) * lda + k0 + tig * 16);
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(
          wt + (size_t)(n0 + j * 8 + gid) * K + k0 + tig * 16));
      mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
      mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
    }
  }
}

// x [M, d] bf16; g, bl [d] f32; w1t [mlp][d] int8 (fc1 transposed); s1, b1
// [mlp] f32; w2t [d][mlp] int8; s2, b2 [d] f32 -> out [M, d] bf16
__global__ void __launch_bounds__(kThreads)
w8a8_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ bl, const int8_t* __restrict__ w1t,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2t, const float* __restrict__ s2,
                const float* __restrict__ b2, bf16* __restrict__ out, int M, int d, int mlp,
                int erf_form, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + kPadQ, ldq = mlp + kPadQ, ldh = mlp + kPadH;
  size_t off = 0;
  int8_t* aq = reinterpret_cast<int8_t*>(smem + off); off += align128((size_t)BM * lda);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + off); off += align128((size_t)BM * ldq);
  float* hf = reinterpret_cast<float*>(smem + off); off += align128((size_t)BM * ldh * 4);
  float* a_s = reinterpret_cast<float*>(smem + off);  // [BM] LN scales
  float* h_s = a_s + BM;                               // [BM] hidden scales
  float* part = h_s + BM;                              // [kWarps][BM] hidden amax by warp

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // 1. LN in f32 (a warp per row), staged in hf; row scale; int8 codes
  for (int r = warp; r < BM; r += kWarps) {
    int8_t* qrow = aq + (size_t)r * lda;
    if (row0 + r >= M) {
      for (int c = lane; c < d; c += 32) qrow[c] = 0;
      if (lane == 0) a_s[r] = 0.f;
      continue;
    }
    float* lrow = hf + (size_t)r * ldh;
    const bf16* xr = x + (size_t)(row0 + r) * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = __fadd_rn(s, __bfloat162float(xr[c]));
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float mu = __fdiv_rn(s, (float)d);
    float v = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xc = __fsub_rn(__bfloat162float(xr[c]), mu);
      v = __fadd_rn(v, __fmul_rn(xc, xc));
    }
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(v, (float)d), eps)));
    float amax = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xc = __fsub_rn(__bfloat162float(xr[c]), mu);
      const float ln = __fadd_rn(__fmul_rn(__fmul_rn(xc, rs), g[c]), bl[c]);
      lrow[c] = ln;
      amax = fmaxf(amax, fabsf(ln));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = __fdiv_rn(amax, 127.f);
    for (int c = lane; c < d; c += 32) qrow[c] = (int8_t)quant(lrow[c], sc);  // own writes
    if (lane == 0) a_s[r] = sc;
  }
  __syncthreads();

  // 2. fc1, the f32 epilogue and GELU into hf; each warp's row amax
  float amax_lo = 0.f, amax_hi = 0.f;  // rows gid, gid + 8
  const int cols1 = mlp / kWarps;
  for (int n0 = warp * cols1; n0 < (warp + 1) * cols1; n0 += NP) {
    int acc[NP / 8][4];
    product_pass(aq, lda, w1t, d, n0, acc);
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + (e >= 2 ? 8 : 0);
        const int c = n0 + j * 8 + tig * 2 + (e & 1);
        float h = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][e]), __fmul_rn(a_s[r], s1[c])), b1[c]);
        h = erf_form ? gelu_erf_rn(h) : gelu_tanh_rn(h);
        hf[(size_t)r * ldh + c] = h;
        if (e < 2) amax_lo = fmaxf(amax_lo, fabsf(h));
        else amax_hi = fmaxf(amax_hi, fabsf(h));
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, o));
    amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, o));
  }
  if (tig == 0) {
    part[warp * BM + gid] = amax_lo;
    part[warp * BM + gid + 8] = amax_hi;
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    float m = 0.f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[w * BM + threadIdx.x]);
    h_s[threadIdx.x] = __fdiv_rn(m, 127.f);
  }
  __syncthreads();

  // 3. the hidden row's int8 codes, four at a time
  const int quads = mlp / 4;
  for (int i = threadIdx.x; i < BM * quads; i += kThreads) {
    const int r = i / quads, c = (i % quads) * 4;
    const float4 h = *reinterpret_cast<const float4*>(hf + (size_t)r * ldh + c);
    const float sc = h_s[r];
    const uint32_t packed = (uint32_t)(quant(h.x, sc) & 0xff) |
                            ((uint32_t)(quant(h.y, sc) & 0xff) << 8) |
                            ((uint32_t)(quant(h.z, sc) & 0xff) << 16) |
                            ((uint32_t)(quant(h.w, sc) & 0xff) << 24);
    *reinterpret_cast<uint32_t*>(hq + (size_t)r * ldq + c) = packed;
  }
  __syncthreads();

  // 4. fc2, then y = f32(acc) * (h_s * s2) + b2 and out = x + bf16(y)
  const int cols2 = d / kWarps;
  for (int n0 = warp * cols2; n0 < (warp + 1) * cols2; n0 += NP) {
    int acc[NP / 8][4];
    product_pass(hq, ldq, w2t, mlp, n0, acc);
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + (e >= 2 ? 8 : 0);
        const int c = n0 + j * 8 + tig * 2 + (e & 1);
        if (row0 + r >= M) continue;
        const float y =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[j][e]), __fmul_rn(h_s[r], s2[c])), b2[c]);
        const size_t at = (size_t)(row0 + r) * d + c;
        out[at] = __float2bfloat16(__fadd_rn(__bfloat162float(x[at]), round_bf16(y)));
      }
    }
  }
}

size_t w8a8_smem(int d, int mlp) {
  return align128((size_t)BM * (d + kPadQ)) + align128((size_t)BM * (mlp + kPadQ)) +
         align128((size_t)BM * (mlp + kPadH) * 4) + (size_t)(2 + kWarps) * BM * 4;
}

}  // namespace

extern "C" int jl_w8a8_ln_mlp_residual(const bf16* x, const float* g, const float* bl,
                                       const int8_t* w1t, const float* s1, const float* b1,
                                       const int8_t* w2t, const float* s2, const float* b2,
                                       bf16* out, int M, int d, int mlp, int erf_form, float eps,
                                       cudaStream_t stream) {
  if (d % (kWarps * NP) || mlp % (kWarps * NP) || d > mlp) return (int)cudaErrorInvalidValue;
  const size_t smem = w8a8_smem(d, mlp);
  cudaError_t err = cudaFuncSetAttribute(w8a8_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)err;
  }
  w8a8_mlp_kernel<<<ceil_div(M, BM), kThreads, smem, stream>>>(x, g, bl, w1t, s1, b1, w2t, s2,
                                                               b2, out, M, d, mlp, erf_form, eps);
  return (int)cudaGetLastError();
}
