// K10 and K11: int8 weight-only products of a decode step.
//
// K10, jl_int8_matmul, replaces ops/quant.py::int8_matmul of the JAX package
// (_int8_matmul_pallas / _int8_gemv_kernel) and the bias add of its caller
// (models/adapters.py, the dense_q branch): y = bf16(bf16((x . q) * s) + bias)
// for x bf16 [R <= 64, d_in], q int8 [d_in, d_out] (per-output-channel), s
// f32 [d_out] and an optional bf16 bias [d_out] (without one, y is the
// inner rounding). The product accumulates in f32 (int8 -> bf16 is exact).
//
// What bounds it on the H100: device-memory bytes, and the latency of
// getting them in flight. A decode step streams every decoder weight once
// (large-v3: 256 launches, 0.84 GB of int8); a 1280 x 1280 matrix is 1.6 MB
// (0.5 us at 3.35 TB/s), so the whole matrix has to be requested at once.
// Design, one launch: a cluster of 8 blocks owns a 64-column strip of q, and
// block `rank` of it a k-slice of up to 8 x 160 rows (160 at d_in 1280, 640
// at 5120). Each block's slice is requested whole as soon as the block
// starts: up to 8 TMA boxes of [160 k][64 bytes], each on its own mbarrier,
// consumed in order as they land. The products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulators): x is the A operand (up to
// four 16-row tiles staged in shared memory, zero past R), q the B operand.
// A lane loads one 4-byte word (4 columns) from each of its fragment's four
// k rows and converts byte j of each to the fragment of column 4g + j of
// n8 tile j, so a warp's four n8 tiles cover 32 columns with no transposed
// copy of q; the output columns are permuted back at the store. The four
// warps split a strip's two 32-column halves and the k16 steps (even, odd);
// the two k16-step partials add in shared memory, then each rank sends each
// column of its partial [R, 64] through distributed shared memory to the
// rank that owns the column (8 of the 64 each); after one cluster barrier a
// rank sums its eight received partials in rank order, scales, rounds, adds
// the bias, rounds and stores. No scratch in device memory, no atomics, one
// launch: every run sums in the same order, so two runs on the same inputs
// are bitwise equal.
// Every row count takes the tensor cores (R <= 8 fills half of the 16-row
// tile): the products are not what bounds the kernel, the bytes are.
//
// K10's row-parallel partial, jl_int8_row_partial: the same kernel with an
// epilogue that stores the scaled sum a * s as f32, neither rounded nor
// biased: a tensor-parallel rank's share of a row-parallel layer (its k rows
// of q, the whole column's scale). The ranks' partials are summed by the
// caller's all-reduce, then rounded once and the bias added once, as the
// unsplit layer rounds.
//
// jl_int8_kv_write, the port's own kernel (no TPU kernel: the JAX package's
// ops/quant.py::quantize_kv plus lax.dynamic_update_slice, which XLA fuses
// into its decode loop): one decode step's K and V rows of an int8 self
// cache quantized per position and written at each row's position, in one
// launch for both. For k, v [B, H, 1, dh] (bf16 or f32; rows of dh
// contiguous, batch and head strides given), the head-major int8 caches
// [B, H, T, dh], their f32 scale planes [B, H, T] and positions int64 [B]:
// scale = max|a| * f32(1 / 127) (PyTorch's a / 127.0 on the card), q =
// clamp(rint(a / safe), -127, 127) with safe = scale > 0 ? scale : 1, an
// IEEE division (__fdiv_rn) rounded half to even (rintf, as torch.round),
// so q and scale are the bits of quantize_kv followed by the cache writes.
// A warp a (row, K or V): each lane loads dh / 32 values, the max is
// reduced by shuffles, each lane writes its codes and lane 0 the scale.
// It moves ~2 x B H dh x (2 + 1) bytes (125 KB at large-v3's B=16, 20 x 64:
// ~0.04 us at 3.35 TB/s), so it is a launch, not bandwidth: what it buys is
// one launch a self-attention in place of the plain write's launches.
//
// K11, jl_int8_tied_logits, replaces ops/quant.py::int8_tied_logits
// (_int8_tied_logits_pallas / _int8_logits_kernel): logits = (x . q^T) * s
// for x bf16 [R <= 64, D], q int8 row-major [V, D] (per-vocab-row), s f32
// [V] -> f32 [R, V]. The products of bf16 values accumulate in f32, scaled
// after the sum.
//
// What bounds it: bytes, the table (large-v3: 66.4 MB, a 20.9 us bound) read
// once a step. Design (int8_tied_logits_tma_kernel, D % 16 == 0):
// - Persistent: one block an SM, each with a balanced, contiguous share of
//   the ceil(V / 32) tiles of 32 vocab rows, so no wave tail is left.
// - The table streamed by TMA: a 2-D tensor map over [V, D] uint8 (the row
//   pitch D must be a multiple of 16), boxes of [32 rows][64 bytes] (rows
//   at a 64-byte pitch in shared memory: two rows fill the 32 banks, so the
//   16-byte fragment reads below are conflict-free; rows past V and columns
//   past D arrive as zeros). A stage is a box for each of the tile's k
//   parts (eight parts, a 16 KB stage, for up to 16 rows of x; four, 8 KB,
//   above), a ring of up to 128 KB of stages (at least 32 KB in flight at
//   R = 64, where x takes most of shared memory); one producer warp issues
//   them, the consumer warps release them.
// - The products: mma.sync m16n8k16 (bf16 in, f32 accumulators). The
//   table is the A operand: a lane reads 16 bytes of one vocab row of a
//   64-column box (and of the row 8 below) and converts them in registers,
//   exactly, with common.cuh::int8x4_to_bf16x4 (no I2F); the contraction
//   order inside the 64 columns is permuted (the same way for x) so that
//   those 16 bytes are the lane's A fragments of four k16 steps. x, staged
//   once a block in shared memory, is the B operand in n8 tiles of x rows
//   (R <= 8 takes one). Chosen over wgmma, whose register-A form needs 64
//   vocab rows of a warpgroup in lockstep and x in a core-matrix layout:
//   at 2 flops a table byte the products are not what bounds the kernel.
// - Consumer warps: the tile's two 16-row halves times its k parts (warp
//   (half, j) takes box j of every stage); at a tile's end the parts'
//   partials meet in shared memory and are summed in part order, scaled by
//   s[v] in f32 and stored as rows of 32 consecutive vocab entries (out's
//   row pitch V * 4 need not be a multiple of 16, so no TMA store). Sums in
//   a fixed order: two launches give the same bits.
// A row pitch that is not a multiple of 16 bytes cannot be a tensor map:
// D % 16 != 0 takes int8_tied_logits_ragged_kernel, the first port's
// kernel (8 warps of 32 vocab rows, x the A operand, each lane loading 16
// bytes of a row per 64-column step, bytes read one by one at the ragged
// edge); ops/quant.py::int8_logits chooses by that rule.
#include "common.cuh"
#include "tma.cuh"

#include <cooperative_groups.h>

namespace {

using namespace jl;

constexpr int kWarps = kThreads / 32;

// int8 -> bf16 (exact) of two bytes, packed as one B fragment register
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

// --- K10 -----------------------------------------------------------------------

constexpr int kRanks = 8;        // blocks of a cluster: the k-slices of one strip
constexpr int kStrip = 64;       // output columns a cluster owns: bytes of a q row a box reads
constexpr int kRankCols = kStrip / kRanks;  // columns each rank reduces and stores
constexpr int kChunkRows = 160;  // most k rows of one TMA box
constexpr int kMaxChunks = 8;
// a warp covers 32 columns; the warps of a column group split its k16 steps
constexpr int kGroups = kStrip / 32;
constexpr int kMatmulWarps = kGroups > 4 ? kGroups : 4;
constexpr int kParities = kMatmulWarps / kGroups;
constexpr int kMatmulThreads = 32 * kMatmulWarps;

__device__ inline uint32_t ld_u32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// one block of the cluster owning columns [n0, n0 + kStrip): rows [k0, k0 +
// ks) of q in nc chunks of kc rows; MT 16-row tiles of x
// kF32: y is f32 and takes a * s (the row partial); else bf16 with the bias
template <int MT, bool kF32>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kMatmulThreads)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tq, const bf16* __restrict__ x,
                   const float* __restrict__ s, const bf16* __restrict__ bias,
                   void* __restrict__ y, int R, int d_in, int d_out, int kc, int nc) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned to 128 below
  constexpr int kRows = MT * 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ks = kc * nc, ldx = ks + kPad;
  const int n0 = blockIdx.y * kStrip, k0 = rank * ks;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* w = smem_raw + (((raw + 127) & ~127u) - raw);  // [nc * kc][kStrip] int8
  bf16* xs = reinterpret_cast<bf16*>(w + (size_t)ks * kStrip);  // [kRows][ldx]
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(xs) + align128((size_t)kRows * ldx * sizeof(bf16)));
  float* recv = red + kParities * kRows * kStrip;  // [kRanks][kRows][kRankCols]: received
  uint64_t* bars = reinterpret_cast<uint64_t*>(recv + kRows * kStrip);

  // the cluster's blocks have all started before any writes into another's
  // shared memory: this arrival is waited for just before the first write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (threadIdx.x == 0) {
    for (int c = 0; c < nc; ++c) mbar_init(&bars[c], 1);
    fence_barrier_init();
    for (int c = 0; c < nc; ++c) {
      mbar_arrive_expect_tx(&bars[c], (uint32_t)kc * kStrip);
      tma_load_2d(w + (size_t)c * kc * kStrip, &tq, n0, k0 + c * kc, &bars[c]);
    }
  }
  // the scale and bias of the one column this thread stores (kMatmulThreads
  // is a multiple of kRankCols), read now rather than after the reduction
  static_assert(kMatmulThreads % kRankCols == 0, "one stored column per thread");
  const int n_out = n0 + rank * kRankCols + threadIdx.x % kRankCols;
  const float s_out = n_out < d_out ? s[n_out] : 0.f;
  const float b_out = bias != nullptr && n_out < d_out ? __bfloat162float(bias[n_out]) : 0.f;
  // x's k-slice, zero past R and d_in (d_in % 8 == 0: a vector is all in or out)
  const int vecs = ks / 8;
  for (int i = threadIdx.x; i < kRows * vecs; i += kMatmulThreads) {
    const int r = i / vecs, k = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && k0 + k < d_in)
      v = *reinterpret_cast<const uint4*>(x + (size_t)r * d_in + k0 + k);
    *reinterpret_cast<uint4*>(xs + (size_t)r * ldx + k) = v;
  }
  __syncthreads();  // xs written; the barriers initialised

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp % kGroups, parity = warp / kGroups;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  const int steps = kc / 16;
  for (int c = 0; c < nc; ++c) {
    mbar_wait(&bars[c], 0);
    const uint8_t* wc = w + (size_t)c * kc * kStrip + group * 32 + 4 * g;
    for (int st = parity; st < steps; st += kParities) {
      // fragment rows k = 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of this k16
      // step, columns 4g .. 4g + 3 of this group
      const uint8_t* wr = wc + (size_t)(16 * st + 2 * t) * kStrip;
      const uint32_t w0 = ld_u32(wr), w1 = ld_u32(wr + kStrip);
      const uint32_t w2 = ld_u32(wr + 8 * kStrip), w3 = ld_u32(wr + 9 * kStrip);
      const int kx = c * kc + 16 * st + 2 * t;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const bf16* xr = xs + (size_t)(16 * m + g) * ldx + kx;
        a[m][0] = ld_u32(xr);
        a[m][1] = ld_u32(xr + 8 * ldx);
        a[m][2] = ld_u32(xr + 8);
        a[m][3] = ld_u32(xr + 8 * ldx + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tile j: column 4g + j of the group
        const uint32_t b0 = bf16x2_of_int8(static_cast<int8_t>(w0 >> (8 * j)),
                                           static_cast<int8_t>(w1 >> (8 * j)));
        const uint32_t b1 = bf16x2_of_int8(static_cast<int8_t>(w2 >> (8 * j)),
                                           static_cast<int8_t>(w3 >> (8 * j)));
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_bf16(acc[m][j], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
      }
    }
  }
  // accumulator (g [+ 8], 2t + (e & 1)) of n8 tile j is column 4 (2t + (e & 1)) + j
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + g + 8 * (e >> 1);
        const int col = group * 32 + 8 * t + 4 * (e & 1) + j;
        red[(parity * kRows + row) * kStrip + col] = acc[m][j][e];
      }
  __syncthreads();
  // this block's partial (its k16-step parities in order), each column sent
  // to the rank that stores it, into that rank's slot for this rank
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int i = threadIdx.x; i < R * kStrip; i += kMatmulThreads) {
    const int row = i / kStrip, col = i % kStrip;
    float p = red[i];
#pragma unroll
    for (int q = 1; q < kParities; ++q) p += red[q * kRows * kStrip + i];
    float* dst = cluster.map_shared_rank(recv, col / kRankCols);
    dst[(rank * kRows + row) * kRankCols + col % kRankCols] = p;
  }
  cluster.sync();  // every rank's partials have landed

  for (int i = threadIdx.x; i < R * kRankCols; i += kMatmulThreads) {
    const int row = i / kRankCols, c = i % kRankCols;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < kRanks; ++q) a += recv[(q * kRows + row) * kRankCols + c];
    if (n_out < d_out) {
      if constexpr (kF32) {
        static_cast<float*>(y)[(size_t)row * d_out + n_out] = a * s_out;
      } else {
        float v = round_bf16(a * s_out);
        if (bias != nullptr) v += b_out;
        static_cast<bf16*>(y)[(size_t)row * d_out + n_out] = __float2bfloat16(v);
      }
    }
  }
}

template <int MT, bool kF32>
int matmul(const CUtensorMap& tq, const bf16* x, const float* s, const bf16* bias, void* y,
           int R, int d_in, int d_out, int kc, int nc, cudaStream_t stream) {
  const int ks = kc * nc;
  const size_t smem = 128 + (size_t)ks * kStrip + align128((size_t)MT * 16 * (ks + kPad) * 2) +
                      (size_t)(kParities + 1) * MT * 16 * kStrip * 4 + (size_t)nc * 8;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<MT, kF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kRanks, ceil_div(d_out, kStrip));
  int8_matmul_kernel<MT, kF32><<<grid, kMatmulThreads, smem, stream>>>(tq, x, s, bias, y, R,
                                                                       d_in, d_out, kc, nc);
  return (int)cudaGetLastError();
}

// --- K11 -----------------------------------------------------------------------

// the ragged-D kernel (D % 16 != 0)
constexpr int kNT = 4;                     // n8 vocab tiles per warp
constexpr int kVocabPerBlock = kWarps * kNT * 8;

// x [R, D] bf16, q [V, D] int8, s [V] f32 -> out [R, V] f32; MT 16-row tiles
template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_tied_logits_ragged_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                               const float* __restrict__ s, float* __restrict__ out, int R,
                               int V, int D) {
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
int logits_ragged(const bf16* x, const int8_t* q, const float* s, float* out, int R, int V,
                  int D, cudaStream_t stream) {
  const size_t smem = (size_t)MT * 16 * (ceil_div(D, 64) * 64 + kPad) * sizeof(bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_tied_logits_ragged_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_tied_logits_ragged_kernel<MT><<<ceil_div(V, kVocabPerBlock), kThreads, smem, stream>>>(
      x, q, s, out, R, V, D);
  return (int)cudaGetLastError();
}

// the TMA kernel (D % 16 == 0)
constexpr int kTileRows = 32;     // vocab rows of a tile: two m16 halves
constexpr int kBoxCols = 64;      // table bytes (columns) of a box
constexpr int kBoxBytes = kTileRows * kBoxCols;
constexpr int kRingBytes = 128 * 1024;  // the most a ring holds in flight

// the k parts a tile is split into: eight for up to 16 rows of x (sixteen
// consumer warps), four above (x and the parts' partials take the room)
template <int NT> struct LogitsShape {
  static constexpr int kParts = NT <= 2 ? 8 : 4;
  static constexpr int kStageBytes = kParts * kBoxBytes;  // a box for each part
  static constexpr int kConsumers = 2 * kParts;           // warps: two halves x the parts
  static constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
};

// shared memory: the ring, x [NT * 8][Dp + kPad] bf16, the parts'
// partials [kParts][kTileRows][NT * 8 + 1] f32, the barriers
template <int NT>
__host__ __device__ inline size_t tma_logits_smem(int D, int stages) {
  const int dp = ceil_div(D, kBoxCols) * kBoxCols;
  return 128 + (size_t)stages * LogitsShape<NT>::kStageBytes +
         align128((size_t)NT * 8 * (dp + kPad) * 2) +
         align128((size_t)LogitsShape<NT>::kParts * kTileRows * (NT * 8 + 1) * 4) +
         16 * (size_t)stages;
}

template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// x [R, D] bf16, q [V, D] int8 (the tensor map tq), s [V] f32 -> out [R, V]
// f32; NT n8 tiles of x rows (R <= 8 NT); `stages` ring stages
template <int NT>
__global__ void __launch_bounds__(LogitsShape<NT>::kThreads, 1)
int8_tied_logits_tma_kernel(const __grid_constant__ CUtensorMap tq, const bf16* __restrict__ x,
                            const float* __restrict__ s, float* __restrict__ out, int R, int V,
                            int D, int stages) {
  using Shape = LogitsShape<NT>;
  constexpr int kParts = Shape::kParts, kConsumers = Shape::kConsumers;
  constexpr int kXRows = NT * 8, kLdr = kXRows + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 127) & ~127u) - raw);  // [stages][kParts][32][64]
  const int nchunks = ceil_div(D, kBoxCols), dp = nchunks * kBoxCols, ldx = dp + kPad;
  bf16* xs = reinterpret_cast<bf16*>(ring + (size_t)stages * Shape::kStageBytes);  // [kXRows][ldx]
  float* red = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(xs) +
                                        align128((size_t)kXRows * ldx * 2));
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kParts * kTileRows * kLdr);
  uint64_t* empty = full + stages;

  const int tiles = ceil_div(V, kTileRows);
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int steps = ceil_div(nchunks, kParts);  // stages a tile
  const int total = (t1 - t0) * steps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    fence_barrier_init();
  }
  // x, zero past R and D (D % 8 == 0: a 16-byte vector is all in or out)
  const int vecs = dp / 8;
  for (int i = threadIdx.x; i < kXRows * vecs; i += Shape::kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && c < D) val = *reinterpret_cast<const uint4*>(x + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(xs + (size_t)r * ldx + c) = val;
  }
  __syncthreads();  // x staged, the barriers initialised

  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int st = it % stages;
        if (it >= stages) mbar_wait(&empty[st], ((it / stages) - 1) & 1);
        const int row = (t0 + it / steps) * kTileRows, c0 = (it % steps) * kParts;
        const int nb = min(kParts, nchunks - c0);
        mbar_arrive_expect_tx(&full[st], (uint32_t)nb * kBoxBytes);
        for (int j = 0; j < nb; ++j)
          tma_load_2d(ring + (size_t)(st * kParts + j) * kBoxBytes, &tq, (c0 + j) * kBoxCols,
                      row, &full[st]);
      }
    }
    return;
  }

  const int half = warp & 1, kpart = warp >> 1;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float sv = 0.f;  // s of the vocab row this lane stores in the tile's epilogue
  for (int it = 0; it < total; ++it) {
    const int st = it % stages, step = it % steps, tile = t0 + it / steps;
    if (step == 0) {
      const int vr = tile * kTileRows + lane;
      sv = vr < V ? s[vr] : 0.f;
    }
    mbar_wait(&full[st], (it / stages) & 1);
    const int chunk = step * kParts + kpart;
    if (chunk < nchunks) {
      // rows g and g + 8 of this half, bytes 16t .. 16t + 15 of the box
      const uint8_t* tb = ring + (size_t)(st * kParts + kpart) * kBoxBytes +
                          (half * 16 + g) * kBoxCols + 16 * t;
      const uint4 lo = *reinterpret_cast<const uint4*>(tb);
      const uint4 hi = *reinterpret_cast<const uint4*>(tb + 8 * kBoxCols);
      uint4 xw[NT][2];  // x row 8n + g, the same 16 columns
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4* px = reinterpret_cast<const uint4*>(xs + (size_t)(8 * n + g) * ldx +
                                                         chunk * kBoxCols + 16 * t);
        xw[n][0] = px[0];
        xw[n][1] = px[1];
      }
      const uint32_t wlo[4] = {lo.x, lo.y, lo.z, lo.w}, whi[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // k16 step i takes bytes 4i .. 4i + 3 as fragment k = 2t, 2t + 1 (A
        // regs 0, 1; B reg 0) and 2t + 8, 2t + 9 (A regs 2, 3; B reg 1)
        const uint2 a_lo = int8x4_to_bf16x4(wlo[i]), a_hi = int8x4_to_bf16x4(whi[i]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint4 xv = xw[n][i / 2];  // x's words 2i, 2i + 1 of the lane's eight
          mma_bf16(acc[n], a_lo.x, a_hi.x, a_lo.y, a_hi.y, i % 2 ? xv.z : xv.x,
                   i % 2 ? xv.w : xv.y);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (step == steps - 1) {
      // accumulator (g [+ 8], 2t + (e & 1)) of n8 tile n: vocab row half * 16
      // + g [+ 8] of the tile, x row 8n + 2t + (e & 1)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(kpart * kTileRows + half * 16 + g + 8 * (e >> 1)) * kLdr + 8 * n + 2 * t +
              (e & 1)] = acc[n][e];
          acc[n][e] = 0.f;
        }
      consumer_sync<32 * kConsumers>();
      // lane -> vocab row of the tile, warp -> x rows: 32 consecutive floats a store
      const int v = tile * kTileRows + lane;
      for (int r = warp; r < R; r += kConsumers) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kParts; ++j) a += red[(j * kTileRows + lane) * kLdr + r];
        if (v < V) out[(size_t)r * V + v] = a * sv;
      }
      consumer_sync<32 * kConsumers>();  // red is free for the next tile
    }
  }
}

template <int NT>
int logits_tma(const CUtensorMap& tq, const bf16* x, const float* s, float* out, int R, int V,
               int D, cudaStream_t stream) {
  using Shape = LogitsShape<NT>;
  int stages = kRingBytes / Shape::kStageBytes;
  while (stages >= 2 && tma_logits_smem<NT>(D, stages) > 232448) --stages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = tma_logits_smem<NT>(D, stages);
  cudaError_t err = cudaFuncSetAttribute(int8_tied_logits_tma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(sm_count(), ceil_div(V, kTileRows));
  int8_tied_logits_tma_kernel<NT><<<grid, Shape::kThreads, smem, stream>>>(tq, x, s, out, R, V,
                                                                           D, stages);
  return (int)cudaGetLastError();
}

// the k slices of the cluster, the tensor map, then the row-tile instance
template <bool kF32>
int int8_matmul_launch(const bf16* x, const int8_t* q, const float* s, const bf16* bias,
                       void* y, int R, int d_in, int d_out, cudaStream_t stream) {
  if (R <= 0 || R > 64 || d_in <= 0 || d_in % 8 || d_out <= 0 || d_out % 16)
    return (int)cudaErrorInvalidValue;
  const int per_rank = ceil_div(ceil_div(d_in, kRanks), 16) * 16;
  const int nc = ceil_div(per_rank, kChunkRows);
  const int kc = ceil_div(ceil_div(per_rank, nc), 16) * 16;
  if (nc > kMaxChunks) return (int)cudaErrorInvalidValue;
  CUtensorMap tq;
  if (!make_tmap_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, d_out, d_in, d_out, kStrip, kc,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (R <= 16) return matmul<1, kF32>(tq, x, s, bias, y, R, d_in, d_out, kc, nc, stream);
  if (R <= 32) return matmul<2, kF32>(tq, x, s, bias, y, R, d_in, d_out, kc, nc, stream);
  return matmul<4, kF32>(tq, x, s, bias, y, R, d_in, d_out, kc, nc, stream);
}

}  // namespace

// bias: bf16 [d_out] or null. d_in % 8 == 0, d_out % 16 == 0 (the TMA row
// pitch), d_in at most 8 x 8 x 160 (less at large R: shared memory).
extern "C" int jl_int8_matmul(const bf16* x, const int8_t* q, const float* s, const bf16* bias,
                              bf16* y, int R, int d_in, int d_out, cudaStream_t stream) {
  return int8_matmul_launch<false>(x, q, s, bias, y, R, d_in, d_out, stream);
}

// y f32 [R, d_out] = (x . q) * s, unrounded, no bias; jl_int8_matmul's shape rule
extern "C" int jl_int8_row_partial(const bf16* x, const int8_t* q, const float* s, float* y,
                                   int R, int d_in, int d_out, cudaStream_t stream) {
  return int8_matmul_launch<true>(x, q, s, nullptr, y, R, d_in, d_out, stream);
}

// D % 16 == 0 (the table's row pitch in a tensor map); x 16-byte aligned
extern "C" int jl_int8_tied_logits(const bf16* x, const int8_t* q, const float* s, float* out,
                                   int R, int V, int D, cudaStream_t stream) {
  if (R <= 0 || R > 64 || V <= 0 || D <= 0 || D % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap tq;
  if (!make_tmap_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, D, V, D, kBoxCols, kTileRows,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (R <= 8) return logits_tma<1>(tq, x, s, out, R, V, D, stream);
  if (R <= 16) return logits_tma<2>(tq, x, s, out, R, V, D, stream);
  if (R <= 32) return logits_tma<4>(tq, x, s, out, R, V, D, stream);
  return logits_tma<8>(tq, x, s, out, R, V, D, stream);
}

// any D (the rule above sends only D % 16 != 0 here)
extern "C" int jl_int8_tied_logits_ragged(const bf16* x, const int8_t* q, const float* s,
                                          float* out, int R, int V, int D, cudaStream_t stream) {
  if (R <= 0 || R > 64 || D <= 0) return (int)cudaErrorInvalidValue;
  if (R <= 16) return logits_ragged<1>(x, q, s, out, R, V, D, stream);
  if (R <= 32) return logits_ragged<2>(x, q, s, out, R, V, D, stream);
  return logits_ragged<4>(x, q, s, out, R, V, D, stream);
}

namespace {

constexpr int kKvThreads = 256;  // 8 warps, a warp a (row, K or V)
constexpr int kKvMaxPerLane = 8;  // dh <= 256
constexpr float kKvInv127 = 1.0f / 127.0f;  // f32(1 / 127), as PyTorch's x / 127.0 on the card

__device__ __forceinline__ float kv_load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float kv_load(const float* p) { return *p; }

template <typename T>
__global__ void __launch_bounds__(kKvThreads)
int8_kv_write_kernel(const T* __restrict__ k, const T* __restrict__ v, long long sb,
                     long long sh, int8_t* __restrict__ kq, float* __restrict__ ks,
                     int8_t* __restrict__ vq, float* __restrict__ vs,
                     const long long* __restrict__ pos, int B, int H, int T_cache, int dh) {
  const int warp = blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int rows = B * H;
  if (warp >= 2 * rows) return;
  const bool is_v = warp >= rows;
  const int r = is_v ? warp - rows : warp;
  const int b = r / H, h = r % H;
  const long long p = pos[b];
  if (p < 0 || p >= T_cache) return;  // no row past the cache (the loops never ask)
  const T* a = (is_v ? v : k) + b * sb + h * sh;
  const int n = dh / 32;
  float x[kKvMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kKvMaxPerLane; ++i) {
    if (i < n) {
      x[i] = kv_load(a + lane + 32 * i);
      amax = fmaxf(amax, fabsf(x[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(amax, kKvInv127);
  const float safe = scale > 0.f ? scale : 1.f;
  const long long row = ((long long)b * H + h) * T_cache + p;
  int8_t* q = (is_v ? vq : kq) + row * dh;
#pragma unroll
  for (int i = 0; i < kKvMaxPerLane; ++i) {
    if (i < n) {
      const float c = fminf(fmaxf(rintf(__fdiv_rn(x[i], safe)), -127.f), 127.f);
      q[lane + 32 * i] = (int8_t)c;
    }
  }
  if (lane == 0) (is_v ? vs : ks)[row] = scale;
}

template <typename T>
int kv_write(const void* k, const void* v, long long sb, long long sh, int8_t* kq, float* ks,
             int8_t* vq, float* vs, const long long* pos, int B, int H, int T_cache, int dh,
             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T_cache <= 0 || dh <= 0 || dh % 32 || dh > 32 * kKvMaxPerLane)
    return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(2 * B * H, kKvThreads / 32);
  int8_kv_write_kernel<T><<<blocks, kKvThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), sb, sh, kq, ks, vq, vs, pos, B, H,
      T_cache, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// k, v [B, H, 1, dh] (f32 when is_f32, else bf16; element strides sb, sh of
// a batch and a head, dh contiguous); kq, vq int8 [B, H, T, dh]; ks, vs f32
// [B, H, T]; pos int64 [B]. dh % 32 == 0, dh <= 256.
extern "C" int jl_int8_kv_write(const void* k, const void* v, long long sb, long long sh,
                                int8_t* kq, float* ks, int8_t* vq, float* vs,
                                const long long* pos, int B, int H, int T_cache, int dh,
                                int is_f32, cudaStream_t stream) {
  return is_f32 ? kv_write<float>(k, v, sb, sh, kq, ks, vq, vs, pos, B, H, T_cache, dh, stream)
                : kv_write<bf16>(k, v, sb, sh, kq, ks, vq, vs, pos, B, H, T_cache, dh, stream);
}
