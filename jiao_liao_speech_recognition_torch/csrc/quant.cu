// K10 and K11: int8 weight-only products of a decode step.
//
// K10, jl_int8_matmul, replaces ops/quant.py::int8_matmul of the JAX package
// (_int8_matmul_pallas / _int8_gemv_kernel): y = (x . q) * s for x bf16
// [R <= 64, d_in], q int8 [d_in, d_out] (per-output-channel), s f32 [d_out]
// -> y bf16 [R, d_out]. The product accumulates in f32 (int8 -> float is
// exact), s is applied once per column and y is rounded to bf16 once.
//
// What bounds it on the H100: device-memory bytes. A decode step streams
// every decoder weight once (large-v3: 256 launches, 0.84 GB of int8) for
// 2R flops per byte; a 1280 x 1280 matrix is 1.6 MB (0.5 us at 3.35 TB/s),
// too little for one block per 64 columns (20 blocks) to pull bandwidth.
// Design: a block owns 32 columns and a 256-row chunk of d_in (grid 40 x 5 at
// 1280 x 1280, 40 x 20 at 5120 -> 1280): each thread reads 4 columns (one
// 4-byte load) of 8 rows, all eight loads issued before the FMAs, and keeps
// up to 16 rows of x's f32 sums in registers (x is staged in shared memory,
// f32, transposed); the 32 k-lanes reduce by shuffles and shared memory in a
// fixed order into an f32 partial buffer [chunks, R, d_out], and a second
// launch sums the chunks in order, scales and rounds. No atomics, so every
// run sums in the same order. Rows past 16 take more blocks (grid z).
//
// K11, jl_int8_tied_logits, replaces ops/quant.py::int8_tied_logits
// (_int8_tied_logits_pallas / _int8_logits_kernel): logits = (x . q^T) * s
// for x bf16 [R <= 64, D], q int8 row-major [V, D] (per-vocab-row), s f32
// [V] -> f32 [R, V].
//
// What bounds it: bytes again, the table (large-v3: 66.4 MB, ~20 us) read
// once a step. At R=16 it is 2.1 GFLOP, too much for CUDA-core FMAs at the
// byte rate, so it runs on the tensor cores: mma.sync m16n8k16 bf16 with
// f32 accumulation, x as the A operand (16-row tiles from shared memory),
// the table as B. A row-major [V, D] table already is the "col" B operand,
// so no transposed copy exists. Each lane loads 16 contiguous bytes of one
// vocab row per 64-column step and converts them to bf16 in registers; the
// contraction order inside the 64 columns is permuted (the same way for x)
// so that those 16 bytes are the lane's B fragments of four k16 steps.
// A block of 8 warps owns 256 vocab rows (4 n8 tiles a warp); the ragged
// vocab tail is masked and any D is taken (D % 16 != 0 reads bytes).
#include "common.cuh"

namespace {

using namespace jl;

constexpr int kWarps = kThreads / 32;

// --- K10 -----------------------------------------------------------------------

constexpr int kCols = 32;    // output columns per block: 8 lanes x 4
constexpr int kChunk = 256;  // d_in rows per block: 32 k-lanes x 8
constexpr int kKIter = kChunk / 32;

template <int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_partial(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                  float* __restrict__ part, int R, int d_in, int d_out) {
  __shared__ float xs[kChunk][RB + 1];  // x of this chunk, f32, [k][row]
  __shared__ float red[kWarps][RB][kCols];
  const int cl = threadIdx.x % 8, kl = threadIdx.x / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols + cl * 4;
  const int k0 = blockIdx.y * kChunk;
  const int r0 = blockIdx.z * RB;

  // thread t stages column k0 + t of the RB rows: consecutive threads read
  // consecutive columns, and all RB loads are issued before the stores
  static_assert(kChunk == kThreads, "one staged column per thread");
  const int kx = k0 + threadIdx.x;
  float val[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    val[r] = r0 + r < R && kx < d_in ? __bfloat162float(x[(size_t)(r0 + r) * d_in + kx]) : 0.f;
#pragma unroll
  for (int r = 0; r < RB; ++r) xs[threadIdx.x][r] = val[r];
  __syncthreads();

  char4 w[kKIter];
#pragma unroll
  for (int it = 0; it < kKIter; ++it) {
    const int k = k0 + kl + it * 32;
    w[it] = make_char4(0, 0, 0, 0);
    if (col0 < d_out && k < d_in)
      w[it] = *reinterpret_cast<const char4*>(q + (size_t)k * d_out + col0);
  }
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int it = 0; it < kKIter; ++it) {
    const float w0 = w[it].x, w1 = w[it].y, w2 = w[it].z, w3 = w[it].w;
    const float* xr = xs[kl + it * 32];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float xv = xr[r];
      acc[r][0] = fmaf(xv, w0, acc[r][0]);
      acc[r][1] = fmaf(xv, w1, acc[r][1]);
      acc[r][2] = fmaf(xv, w2, acc[r][2]);
      acc[r][3] = fmaf(xv, w3, acc[r][3]);
    }
  }
  // the four k-lanes of a warp (lanes 8 apart), then the eight warps
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float a = acc[r][c];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      if (lane < 8) red[warp][r][cl * 4 + c] = a;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    float a = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) a += red[wp][r][c];
    const int row = r0 + r, col = blockIdx.x * kCols + c;
    if (row < R && col < d_out) part[((size_t)blockIdx.y * R + row) * d_out + col] = a;
  }
}

__global__ void int8_gemv_finish(const float* __restrict__ part, const float* __restrict__ s,
                                 bf16* __restrict__ y, int R, int d_out, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * d_out) return;
  float a = 0.f;
  for (int c = 0; c < chunks; ++c) a += part[(size_t)c * R * d_out + i];
  y[i] = __float2bfloat16(a * s[i % d_out]);
}

template <int RB>
int gemv(const bf16* x, const int8_t* q, const float* s, float* part, bf16* y, int R, int d_in,
         int d_out, cudaStream_t stream) {
  const int chunks = ceil_div(d_in, kChunk);
  const dim3 grid(ceil_div(d_out, kCols), chunks, ceil_div(R, RB));
  int8_gemv_partial<RB><<<grid, kThreads, 0, stream>>>(x, q, part, R, d_in, d_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int8_gemv_finish<<<ceil_div(R * d_out, kThreads), kThreads, 0, stream>>>(part, s, y, R, d_out,
                                                                           chunks);
  return (int)cudaGetLastError();
}

// --- K11 -----------------------------------------------------------------------

constexpr int kNT = 4;                     // n8 vocab tiles per warp
constexpr int kVocabPerBlock = kWarps * kNT * 8;

__device__ inline uint32_t bf16x2_of_int8(int8_t lo, int8_t hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ inline void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x [R, D] bf16, q [V, D] int8, s [V] f32 -> out [R, V] f32; MT 16-row tiles
template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_tied_logits_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out, int R, int V,
                        int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [MT * 16][Dp + kPad], zero past R and D
  const int Dp = ceil_div(D, 64) * 64;
  const int ldx = Dp + kPad;
  for (int i = threadIdx.x; i < MT * 16 * Dp; i += kThreads) {
    const int r = i / Dp, c = i % Dp;
    xs[(size_t)r * ldx + c] = (r < R && c < D) ? x[(size_t)r * D + c] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  const int v0 = blockIdx.x * kVocabPerBlock + warp * kNT * 8;
  const bool aligned = D % 16 == 0;
  float acc[MT][kNT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int c0 = 0; c0 < Dp; c0 += 64) {
    const int off = c0 + 16 * t;  // this lane's 16 columns of the 64
    uint4 braw[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int v = v0 + n * 8 + g;
      braw[n] = make_uint4(0u, 0u, 0u, 0u);
      if (v < V) {
        const int8_t* row = q + (size_t)v * D;
        if (aligned && off + 16 <= D) {
          braw[n] = *reinterpret_cast<const uint4*>(row + off);
        } else {
          int8_t* b = reinterpret_cast<int8_t*>(&braw[n]);
          for (int j = 0; j < 16; ++j) b[j] = off + j < D ? row[off + j] : 0;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // rows g and g + 8 of this tile, columns off .. off + 15 (8 bf16 pairs each)
      const uint4* plo = reinterpret_cast<const uint4*>(xs + (size_t)(m * 16 + g) * ldx + off);
      const uint4* phi = reinterpret_cast<const uint4*>(xs + (size_t)(m * 16 + g + 8) * ldx + off);
      const uint4 lo0 = plo[0], lo1 = plo[1], hi0 = phi[0], hi1 = phi[1];
      const uint32_t wlo[8] = {lo0.x, lo0.y, lo0.z, lo0.w, lo1.x, lo1.y, lo1.z, lo1.w};
      const uint32_t whi[8] = {hi0.x, hi0.y, hi0.z, hi0.w, hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // k16 step i takes columns off + 4i .. off + 4i + 3 as fragment
        // k = 2t, 2t + 1 (A reg 0/1, B reg 0) and 2t + 8, 2t + 9 (A reg 2/3, B reg 1)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint32_t word = (&braw[n].x)[i];  // bytes: columns off + 4i .. + 3
          mma_bf16(acc[m][n], wlo[2 * i], whi[2 * i], wlo[2 * i + 1], whi[2 * i + 1],
                   bf16x2_of_int8(static_cast<int8_t>(word), static_cast<int8_t>(word >> 8)),
                   bf16x2_of_int8(static_cast<int8_t>(word >> 16),
                                  static_cast<int8_t>(word >> 24)));
        }
      }
    }
  }
  // accumulator (g, 2t + {0, 1}) and (g + 8, 2t + {0, 1}) of each tile
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m * 16 + g + (e >= 2 ? 8 : 0);
        const int v = v0 + n * 8 + 2 * t + (e & 1);
        if (r < R && v < V) out[(size_t)r * V + v] = acc[m][n][e] * s[v];
      }
}

template <int MT>
int logits(const bf16* x, const int8_t* q, const float* s, float* out, int R, int V, int D,
           cudaStream_t stream) {
  const size_t smem = (size_t)MT * 16 * (ceil_div(D, 64) * 64 + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(int8_tied_logits_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_tied_logits_kernel<MT><<<ceil_div(V, kVocabPerBlock), kThreads, smem, stream>>>(
      x, q, s, out, R, V, D);
  return (int)cudaGetLastError();
}

}  // namespace

// part: f32 scratch [ceil(d_in / 256), R, d_out] (the wrapper allocates it)
extern "C" int jl_int8_matmul(const bf16* x, const int8_t* q, const float* s, float* part,
                              bf16* y, int R, int d_in, int d_out, cudaStream_t stream) {
  if (R <= 0 || R > 64 || d_out % 4) return (int)cudaErrorInvalidValue;
  if (R == 1) return gemv<1>(x, q, s, part, y, R, d_in, d_out, stream);
  if (R <= 2) return gemv<2>(x, q, s, part, y, R, d_in, d_out, stream);
  if (R <= 4) return gemv<4>(x, q, s, part, y, R, d_in, d_out, stream);
  if (R <= 8) return gemv<8>(x, q, s, part, y, R, d_in, d_out, stream);
  return gemv<16>(x, q, s, part, y, R, d_in, d_out, stream);
}

extern "C" int jl_int8_tied_logits(const bf16* x, const int8_t* q, const float* s, float* out,
                                   int R, int V, int D, cudaStream_t stream) {
  if (R <= 0 || R > 64 || D <= 0) return (int)cudaErrorInvalidValue;
  if (R <= 16) return logits<1>(x, q, s, out, R, V, D, stream);
  if (R <= 32) return logits<2>(x, q, s, out, R, V, D, stream);
  return logits<4>(x, q, s, out, R, V, D, stream);
}
