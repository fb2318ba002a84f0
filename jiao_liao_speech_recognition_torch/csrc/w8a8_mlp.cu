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
// form; the LN's 1 / sqrt is rsqrtf, as torch.rsqrt on the card. A scale
// amax / 127 is amax * f32(1 / 127): PyTorch on the card divides a tensor
// by a Python scalar as a product with the scalar's f32 reciprocal (a true
// division moved 4,898 of 24,000 LN scales by an ulp on the H100), and the
// LN row statistics are summed in the order of PyTorch's CUDA mean
// (ln_quant_kernel). The LN codes and scales, the hidden codes and the
// output are then the plain version's bits on the card (chip_smoke.py
// checks each stage).
//
// What bounds it on the H100: int8 tensor-core work, 4 * rows * d * mlp
// operations (100.7 G at 32 x 750 rows, d 512, mlp 2048: 0.051 ms at 1,979
// TOPS); the bytes (x in, y out, 2 MB of int8 weights) take 0.015 ms. What
// holds it back in practice is the f32 epilogue on the CUDA cores: a GELU
// (tanhf), an IEEE division and a rounding for each of the rows x mlp
// hidden values.
//
// Design. The hidden scale h_s spans the whole row of mlp columns, so fc2
// cannot start on a hidden chunk before fc1 and the GELU have covered the
// row. Of the ways out:
//  (a) fc1 twice inside one kernel that feeds each quantized hidden chunk
//      straight into fc2 cannot hold a row block of 128: its fc2
//      accumulators (128 rows x d = 512 of s32) are the whole register
//      file of an SM, so a 128-row block would have to split d across
//      blocks and run fc1 four times;
//  (b) fc1 once, writing the f32 hidden tensor (2 x 196.6 MB through
//      device memory, ~0.12 ms at 3.35 TB/s) for a quantize pass;
//  (c) a cluster sharing the row amax through distributed shared memory
//      still has to hold the hidden row somewhere while it waits.
// This kernel takes (a)'s two fc1 passes as launches of one TMA + wgmma
// GEMM (b)'s way, so the hidden tensor crosses device memory only as int8
// codes (49 MB written, read once):
//  1. ln_quant: one warp a row; LN, the row's scale and int8 codes, and the
//     row's hidden amax set to 0;
//  2. gemm<kAmax>: fc1, the dequantized h + b1 and its GELU, each row's
//     amax|GELU(h)| over the tile merged into the row's amax with an
//     integer atomicMax on the float's bits (non-negative floats order as
//     their bits do, so any order of merges gives the same amax: no
//     atomics on values, two launches give the same bits);
//  3. gemm<kQuant>: fc1 again (an exact int32 sum, the same f32 steps: h
//     bit for bit the first pass's), GELU, the codes with h_s = amax / 127,
//     staged in shared memory and stored by TMA;
//  4. gemm<kResidual>: fc2 on the codes, y and the residual.
// The three GEMM launches are csrc/ln_gemm.cu's persistent GEMM on int8
// operands (w8a8_tile_kernel): one block an SM walking 128 x 128 output
// tiles (rows past M read as zeros by TMA, never written), a producer
// warpgroup whose one thread keeps five k-blocks of 128 int8 (one 128-byte
// swizzled row) in flight across tiles, both operands K-major (the 8-bit
// wgmma takes no other layout: the weights come as [n][k], made once by
// ops/probes.w8a8_operands), and two consumer warpgroups taking the
// block's tiles in turn, each a whole tile (wgmma m64n128k32 s8, 128 s32
// accumulators a thread), so one's epilogue runs beside the other's
// products. A 128-row tile reads each weight once per 128 rows: L2 -> SM
// weight traffic is 3 MB per 128 rows (fc1 twice, fc2 once), against 2 MB
// per 16 rows before. Shapes: d and mlp multiples of 128, d <= 2048 (the
// LN row pass holds a row in registers); the launch returns an error
// otherwise. Tried on the H100 and not kept, each slower than this design
// in the same run (PERF.md): two blocks an SM, each a pair of warpgroups
// on one tile; one consumer warpgroup a whole tile under setmaxnreg 232;
// the amax launch taking the GELU only where it could reach the row's
// amax (exact, by GELU(h) <= h for h >= 0: the branches cost more than
// the GELUs they skip).
//
// w8a8_tile_kernel and csrc/ln_gemm.cu's gemm_kernel are twins: the same
// producer k-block loop, turn barriers (and their parity argument), `done`
// barrier and untimed consumer waits. They are not one template: here a
// tile is a pair of warpgroups on K-major int8 operands at 104 registers,
// there one warpgroup on an N-major bf16 weight at 232, with a residual
// loaded by TMA into the staging buffer and fc1's GELU table shared with
// the producer's spare warps. A fix to either's pipeline or barrier
// protocol belongs in both.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kBM = 128;  // tile rows: a pair of consumer warpgroups, 64 each
constexpr int kBN = 128;  // tile columns: one m64n128k32 product a warpgroup and k32 step
constexpr int kBK = 128;  // k a stage: one 128-byte swizzled row of int8
// two pairs of consumer warpgroups taking the tiles in turn, and a producer
// warpgroup (one thread issues every load; setmaxnreg acts on whole
// warpgroups). A block starts at 96 registers a thread (65,536 / 640,
// rounded down to 8); the consumers can take only what the producer gives
// up: (104 - 96) x 512 <= (96 - 40) x 128 (112 beside a producer at 40
// stalled the first launch until its timed wait trapped, on the H100)
constexpr int kConsumerWGs = 4;
constexpr int kGemmThreads = (kConsumerWGs + 1) * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 104;
constexpr int kStages = 5;                     // k-blocks in flight, across tiles
constexpr uint32_t kBoxBytes = kBM * kBK;      // an A or a B box: 16 KB
constexpr uint32_t kStageBytes = 2 * kBoxBytes;
// named barriers (0 is __syncthreads): pair p waits on kTurnBarrier + p
// (with the other pair: 512 threads) before its tile's products;
// kEpiBarrier + w is consumer warpgroup w's own
constexpr int kTurnBarrier = 1;
constexpr int kEpiBarrier = 3;

constexpr int kLnWarps = 8;    // rows per ln_quant block
constexpr int kLnMaxVecs = 16;  // 4-element vectors a lane holds: d <= 16 x 32 x 4
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1 / 127), as PyTorch's x / 127.0

enum Epilogue { kAmax, kQuant, kResidual };

// a block's dynamic shared memory, from a 1024-aligned base: the stages,
// the consumer warpgroups' staged int8 codes (kQuant: 64 rows each), then
// the barriers
template <int EPI>
struct Layout {
  static constexpr uint32_t kOutBytes = EPI == kQuant ? 64 * kBN : 0;
  static constexpr size_t kOut = (size_t)kStages * kStageBytes;
  static constexpr size_t kBar = kOut + kConsumerWGs * kOutBytes;
  static constexpr size_t kBytes = 1024 + kBar + (2 * kStages + 1) * sizeof(uint64_t);
};

// clip(rint(v / safe), -127, 127), safe = s where s > 0, else 1
__device__ __forceinline__ int quant(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s > 0.f ? s : 1.f));
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// the op order of ops/fused_mlp.gelu_f32 (jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gelu_tanh_rn(float h) {
  const float h3 = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
  return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// the Abramowitz-Stegun 7.1.26 rational of ops/fused_mlp.gelu_f32
__device__ __forceinline__ float gelu_erf_rn(float h) {
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

template <int ERF>
__device__ __forceinline__ float gelu_rn(float h) {
  return ERF ? gelu_erf_rn(h) : gelu_tanh_rn(h);
}

// a lane's four row-statistic accumulators combined left to right, then
// summed over the warp with offsets 16, 8, 4, 2, 1 (every lane gets lane
// 0's sum: f32 addition commutes)
__device__ __forceinline__ float warp_row_sum(const float (&acc)[4]) {
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// x [M, d] bf16, g / bl [d] f32 -> lq [M, d] int8, a_s [M] f32; amax [M]
// (the hidden rows' amax, which gemm<kAmax> raises) set to 0. A lane holds
// the 4-element vectors lane, lane + 32, ... of the row (d / 128 of them,
// VECS at most) as loaded, and computes each LN value twice (the row's
// amax, then its code), the same bits each time. The mean and the variance are summed
// in the order of PyTorch's CUDA mean over a row of 128 or more f32 values
// (ATen's vectorized reduce: four accumulators a lane, one for each element
// of its 4-wide vectors, over its vectors in order; then warp_row_sum;
// times the factor f32(M) / f32(M d)), so at M >= 16 rows (fewer widen
// PyTorch's block, another order) the statistics, the LN values and so the
// scales and codes are the plain version's bits on the card.
template <int VECS>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ bl, int8_t* __restrict__ lq, float* __restrict__ a_s,
                float* __restrict__ amax, int M, int d, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int nv = d / 128;
  // PyTorch's mean factor: float(outputs) / numel, numel converted to f32
  const float factor = __fdiv_rn(__int2float_rn(M), __ll2float_rn((long long)M * d));
  const uint2* xr = reinterpret_cast<const uint2*>(x + (size_t)row * d);
  uint2 xv[VECS];  // the row's bf16 values, 4 a vector, kept as loaded
#pragma unroll
  for (int i = 0; i < VECS; ++i)
    if (i < nv) xv[i] = xr[lane + 32 * i];
  // element j of vector i in f32 (a bf16 is the high half of its f32)
  auto val = [&](int i, int j) {
    const uint32_t w = j < 2 ? xv[i].x : xv[i].y;
    return __uint_as_float(j % 2 ? (w & 0xffff0000u) : (w << 16));
  };
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VECS; ++i)
    if (i < nv)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], val(i, j));
  const float mu = __fmul_rn(warp_row_sum(acc), factor);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < VECS; ++i)
    if (i < nv)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = __fsub_rn(val(i, j), mu);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(c, c));
      }
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(warp_row_sum(acc), factor), eps));
  // the LN value of element j of vector i, the same bits in either pass below
  auto ln = [&](int i, int j, const float4& gv, const float4& bv) {
    const float gj = j == 0 ? gv.x : j == 1 ? gv.y : j == 2 ? gv.z : gv.w;
    const float bj = j == 0 ? bv.x : j == 1 ? bv.y : j == 2 ? bv.z : bv.w;
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(val(i, j), mu), rs), gj), bj);
  };
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* b4 = reinterpret_cast<const float4*>(bl);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < VECS; ++i)
    if (i < nv) {
      const float4 gv = g4[lane + 32 * i], bv = b4[lane + 32 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(ln(i, j, gv, bv)));
    }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float sc = __fmul_rn(m, kInv127);
#pragma unroll
  for (int i = 0; i < VECS; ++i)
    if (i < nv) {
      const float4 gv = g4[lane + 32 * i], bv = b4[lane + 32 * i];
      uint32_t w = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= (uint32_t)(quant(ln(i, j, gv, bv), sc) & 0xff) << (8 * j);
      reinterpret_cast<uint32_t*>(lq + (size_t)row * d)[lane + 32 * i] = w;
    }
  if (lane == 0) {
    a_s[row] = sc;
    amax[row] = 0.f;
  }
}

// The epilogue EPI of rows row0 .. row0 + 63 of a 128 x 128 tile at
// columns n0, on a consumer warpgroup's accumulators for them (this
// thread's rows r[0] and r[1] = r[0] + 8, its column pairs 8 q + 2 (tid %
// 4) for q < 16: wg::acc_row/acc_col):
//  kAmax:     h = f32(acc) * (a_s * s) + b, amax[row] = max(amax[row],
//             |GELU(h)|) by atomicMax on the bits;
//  kQuant:    the same h and GELU -> codes with h_s = amax[row] / 127 into
//             `staged` (these 64 rows of the warpgroup's tile, 128-byte
//             rows with the TMA's 128-byte swizzle);
//  kResidual: y = f32(acc) * (h_s * s) + b, out = x + bf16(y) ([M, N] bf16).
// a_s, amax [M]; s, b [N] f32.
template <int EPI, int ERF>
__device__ __forceinline__ void epilogue(const int (&acc)[kBN / 2], int tid, int row0, int n0,
                                         int M, int N, const float* __restrict__ a_s,
                                         float* __restrict__ amax, const float* __restrict__ s,
                                         const float* __restrict__ b,
                                         const bf16* __restrict__ x, bf16* __restrict__ out,
                                         uint8_t* staged) {
  const int r[2] = {row0 + wg::acc_row(tid, 0), row0 + wg::acc_row(tid, 0) + 8};
  float rs[2];  // a_s (fc1's passes) or h_s (fc2) of the two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = r[h] < M ? (EPI == kResidual ? amax[r[h]] : a_s[r[h]]) : 0.f;
    rs[h] = EPI == kResidual ? __fmul_rn(v, kInv127) : v;
  }
  // h (or y) of accumulator i, at column pair q = i / 4
  auto dq = [&](int i, float2 sc, float2 bc) {
    return __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), __fmul_rn(rs[(i >> 1) & 1],
                                                                  (i & 1) ? sc.y : sc.x)),
                     (i & 1) ? bc.y : bc.x);
  };
  if constexpr (EPI == kResidual) {
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
      const int c = n0 + wg::acc_col(tid, 4 * q);
      const float2 sc = *reinterpret_cast<const float2*>(s + c);
      const float2 bc = *reinterpret_cast<const float2*>(b + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r[h] >= M) continue;
        const size_t at = (size_t)r[h] * N + c;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
            __fadd_rn(xv.x, round_bf16(dq(4 * q + 2 * h, sc, bc))),
            __fadd_rn(xv.y, round_bf16(dq(4 * q + 2 * h + 1, sc, bc))));
      }
    }
  } else if constexpr (EPI == kAmax) {
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
      const int c = n0 + wg::acc_col(tid, 4 * q);
      const float2 sc = *reinterpret_cast<const float2*>(s + c);
      const float2 bc = *reinterpret_cast<const float2*>(b + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e >> 1] = fmaxf(m[e >> 1], fabsf(gelu_rn<ERF>(dq(4 * q + e, sc, bc))));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad of threads holding the row
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      if (tid % 4 == 0 && r[h] < M)
        atomicMax(reinterpret_cast<int*>(amax) + r[h], __float_as_int(m[h]));
    }
  } else {  // kQuant
    float hs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) hs[h] = r[h] < M ? __fmul_rn(amax[r[h]], kInv127) : 0.f;
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
      const int cl = wg::acc_col(tid, 4 * q);
      const float2 sc = *reinterpret_cast<const float2*>(s + n0 + cl);
      const float2 bc = *reinterpret_cast<const float2*>(b + n0 + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = quant(gelu_rn<ERF>(dq(4 * q + 2 * h, sc, bc)), hs[h]);
        const int q1 = quant(gelu_rn<ERF>(dq(4 * q + 2 * h + 1, sc, bc)), hs[h]);
        // the code pair at row rr of these 64, byte cl: 16-byte chunk ^ row % 8
        const int rr = wg::acc_row(tid, 0) + 8 * h;
        *reinterpret_cast<uint16_t*>(staged + rr * kBN + (((cl / 16) ^ (rr & 7)) * 16) +
                                     cl % 16) = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
  }
}

// A [M, K] . [N, K]^T int8 product in 128 x 128 tiles (ta maps the codes
// and tb the K-major weight in 128 x 128 boxes, tout kQuant's [M, N] int8
// output in 64-row boxes, all with the 128-byte swizzle), each tile
// through the epilogue EPI above. csrc/ln_gemm.cu's persistent GEMM on int8
// operands: one block an SM walking the tiles t = blockIdx.x, + gridDim.x,
// ... (tile t is rows (t / (N / 128)) * 128 and columns (t % (N / 128)) *
// 128, so the blocks running together share row blocks of A); a producer
// warpgroup whose one thread keeps kStages k-blocks in flight across
// tiles; two pairs of consumer warpgroups taking the block's tiles in
// turn, a warpgroup 64 rows of its pair's tile (wgmma m64n128k32 s8, 64
// s32 accumulators a thread under setmaxnreg 104), the pairs ordered by
// two named barriers so one pair's epilogue runs beside the other's
// products (the epilogue is the longer: a GELU, a division and a rounding
// for each hidden value, on eight warps at a time).
template <int EPI, int ERF>
__global__ void __launch_bounds__(kGemmThreads, 1)
w8a8_tile_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tout, const float* __restrict__ a_s,
                 float* __restrict__ amax, const float* __restrict__ s,
                 const float* __restrict__ b, const bf16* __restrict__ x,
                 bf16* __restrict__ out, int M, int N, int K) {
  using L = Layout<EPI>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // the consumers' last arrival
  const int n_tiles = N / kBN, kblocks = K / kBK, tiles = ceil_div(M, kBM) * n_tiles;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[st], 2);  // the arrivals of the pair that read it
    }
    mbar_init(done, kConsumerWGs);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == kConsumerWGs) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWGs * 128) {
      int g = 0;  // the block's running k-block count: stage g % kStages
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * kBN;
        for (int kb = 0; kb < kblocks; ++kb, ++g) {
          const int st = g % kStages;
          if (g >= kStages) mbar_wait(&empty[st], ((g / kStages) - 1) & 1);
          uint8_t* a = base + (size_t)st * kStageBytes;
          mbar_arrive_expect_tx(&full[st], kStageBytes);
          tma_load_2d(a, &ta, kb * kBK, m0, &full[st]);
          tma_load_2d(a + kBoxBytes, &tb, kb * kBK, n0, &full[st]);
        }
      }
      // the consumers wait untimed (a trap in their region would hold them
      // to the entry register count): a stall traps here instead
      mbar_wait(done, 0);
    }
    return;
  }

  // consumer warpgroup wgi: rows (wgi % 2) * 64 of tiles j = p, p + 2, ...
  // of the block, p = wgi / 2 its pair
  wg::reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, pair = wgi / 2, half = wgi % 2;
  const bool leader = tid == 0;
  uint8_t* staged = base + L::kOut + wgi * L::kOutBytes;
  int acc[kBN / 2];
  for (int j = pair, t = blockIdx.x + pair * gridDim.x; t < tiles;
       j += 2, t += 2 * gridDim.x) {
    const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * kBN;
    // the other pair has passed every stage wait of the tile before
    if (j > 0) wg::named_sync(kTurnBarrier + pair, 512);
    for (int kb = 0; kb < kblocks; ++kb) {
      const int g = j * kblocks + kb, st = g % kStages;
      mbar_wait_untimed(&full[st], (g / kStages) & 1);
      const uint32_t a0 = smem_u32(base + (size_t)st * kStageBytes) + half * 64 * kBK;
      const uint32_t b0 = smem_u32(base + (size_t)st * kStageBytes + kBoxBytes);
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)
        wg::mma(acc, wg::desc_sw128(a0 + 32 * k, 16, 1024),
                wg::desc_sw128(b0 + 32 * k, 16, 1024), kb > 0 || k > 0);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // the previous stage's products are done with it
      if (kb > 0 && leader) mbar_arrive(&empty[(g - 1) % kStages]);
    }
    // the block's next tile is the other pair's: let it start
    if (t + (int)gridDim.x < tiles) wg::named_arrive(kTurnBarrier + (1 - pair), 512);
    wg::wgmma_wait<0>();
    wg::fence_operand(acc);
    if (leader) mbar_arrive(&empty[(j * kblocks + kblocks - 1) % kStages]);

    // the epilogue, while the other pair's products run
    if constexpr (EPI == kQuant) {  // once the last store from the buffer has read it
      if (leader) bulk_wait_read<0>();
      wg::named_sync(kEpiBarrier + wgi, 128);
    }
    epilogue<EPI, ERF>(acc, tid, m0 + half * 64, n0, M, N, a_s, amax, s, b, x, out, staged);
    if constexpr (EPI == kQuant) {
      fence_proxy_async();
      wg::named_sync(kEpiBarrier + wgi, 128);
      if (leader) {
        tma_store_2d(&tout, n0, m0 + half * 64, staged);
        bulk_commit();
      }
    }
  }
  if (leader) {
    bulk_wait<0>();
    mbar_arrive(done);
  }
}

// one launch of the GEMM: a block an SM, or fewer than that many tiles
template <int EPI, int ERF>
int gemm(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout,
         const float* a_s, float* amax, const float* s, const float* b, const bf16* x,
         bf16* out, int M, int N, int K, cudaStream_t stream) {
  // the shared-memory opt-in, once an instance and device
  static int opted_in = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (opted_in != dev) {
    err = cudaFuncSetAttribute(w8a8_tile_kernel<EPI, ERF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<EPI>::kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = dev;
  }
  const int tiles = ceil_div(M, kBM) * (N / kBN), sms = sm_count();
  w8a8_tile_kernel<EPI, ERF><<<tiles < sms ? tiles : sms, kGemmThreads, Layout<EPI>::kBytes,
                               stream>>>(
      ta, tb, tout, a_s, amax, s, b, x, out, M, N, K);
  return (int)cudaGetLastError();
}

template <int VECS>
int ln_quant(const bf16* x, const float* g, const float* bl, int8_t* lq, float* a_s,
             float* amax, int M, int d, float eps, cudaStream_t stream) {
  ln_quant_kernel<VECS><<<ceil_div(M, kLnWarps), kLnWarps * 32, 0, stream>>>(x, g, bl, lq, a_s,
                                                                            amax, M, d, eps);
  return (int)cudaGetLastError();
}

// an int8 [rows, cols] tensor (row pitch cols bytes) in boxes of 128
// columns x box_rows rows, 128-byte swizzle
bool int8_map(CUtensorMap* map, const int8_t* p, int rows, int cols, uint32_t box_rows) {
  return make_tmap_2d(map, p, CU_TENSOR_MAP_DATA_TYPE_UINT8, cols, rows, (uint64_t)cols, kBK,
                      box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int ERF>
int fc1_passes(const CUtensorMap& tl, const CUtensorMap& tw1, const CUtensorMap& thq,
               const float* a_s, float* amax, const float* s1, const float* b1, int M, int d,
               int mlp, cudaStream_t stream) {
  const int err = gemm<kAmax, ERF>(tl, tw1, thq, a_s, amax, s1, b1, nullptr, nullptr, M, mlp, d,
                                   stream);
  return err ? err : gemm<kQuant, ERF>(tl, tw1, thq, a_s, amax, s1, b1, nullptr, nullptr, M,
                                       mlp, d, stream);
}

}  // namespace

// P4: x [M, d] bf16; g, bl [d] f32; w1t [mlp][d] int8 (fc1's codes,
// K-major); s1, b1 [mlp] f32; w2t [d][mlp] int8; s2, b2 [d] f32 -> out
// [M, d] bf16, through the scratch lq [M, d] int8, a_s [M] f32, amax [M]
// f32 and hq [M, mlp] int8 (the LN codes and scales, the hidden rows' amax
// and codes). Four launches; d and mlp multiples of 128, d <= 2048,
// pointers 16-byte aligned.
extern "C" int jl_w8a8_ln_mlp_residual(const bf16* x, const float* g, const float* bl,
                                       const int8_t* w1t, const float* s1, const float* b1,
                                       const int8_t* w2t, const float* s2, const float* b2,
                                       int8_t* lq, float* a_s, float* amax, int8_t* hq,
                                       bf16* out, int M, int d, int mlp, int erf_form, float eps,
                                       cudaStream_t stream) {
  if (M <= 0 || d <= 0 || mlp <= 0 || d % kBK || mlp % kBK || d > kLnMaxVecs * 32 * 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tl, tw1, thq, thq_out, tw2;
  if (!int8_map(&tl, lq, M, d, kBM) || !int8_map(&tw1, w1t, mlp, d, kBN) ||
      !int8_map(&thq, hq, M, mlp, kBM) || !int8_map(&thq_out, hq, M, mlp, 64) ||
      !int8_map(&tw2, w2t, d, mlp, kBN))
    return (int)cudaErrorInvalidValue;
  int err = d <= 512    ? ln_quant<4>(x, g, bl, lq, a_s, amax, M, d, eps, stream)
            : d <= 1024 ? ln_quant<8>(x, g, bl, lq, a_s, amax, M, d, eps, stream)
                        : ln_quant<kLnMaxVecs>(x, g, bl, lq, a_s, amax, M, d, eps, stream);
  if (!err)
    err = erf_form ? fc1_passes<1>(tl, tw1, thq_out, a_s, amax, s1, b1, M, d, mlp, stream)
                   : fc1_passes<0>(tl, tw1, thq_out, a_s, amax, s1, b1, M, d, mlp, stream);
  return err ? err : gemm<kResidual, 0>(thq, tw2, thq, nullptr, amax, s2, b2, x, out, M, d,
                                        mlp, stream);
}
