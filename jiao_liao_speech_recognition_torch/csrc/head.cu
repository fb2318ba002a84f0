// K4: fused CTC head + argmax, ids[r] = argmax_v (x[r] . W[:, v] + b[v]),
// and P2, the same function with the argmax carried in the block.
//
// Replaces ops/fused_head.py::fused_head_argmax (_head_argmax_kernel) of
// the JAX package (K4) and examples/profile_head_kernel.py::_kernel_fori,
// its A/B probe with a runtime loop over 512-column vocabulary chunks (P2).
//
// What bounds it on the H100: the head product on the tensor cores
// (2 * rows * d * V flops: 106.6 GFLOP, 0.108 ms at 989 TFLOP/s, for 32 x
// 750 rows, d 512, V 4336). Its bytes are small beside that (x 24.6 MB,
// W 4.4 MB, ids 0.1 MB). Unfused, the [rows, V] f32 logits (416 MB at that
// size) would be written and read back by a separate argmax; here they
// never leave registers.
//
// Design: the TMA + wgmma mainloop of wgmma_gemm.cuh (wg::Pipeline): 128 x
// 128 output tiles, a producer warp feeding three TMA stages
// (128-byte swizzle), two consumer warpgroups on wgmma m64n128k16, W read
// N-major through the descriptor (no transposed copy). Ragged edges come
// from the tensor maps, not padding: W's map has V as its column extent
// and x's has d and M, so the columns past V, the k past d (the last box of
// a d that is not a multiple of 64) and the rows past M load as zeros.
// Columns at or past V are masked in the epilogue and rows past M never
// written. W's rows must be 16-byte multiples (V padded to a multiple of 8
// once, in the serving copy).
//
// Epilogue, in registers: a consumer thread holds 2 rows x 32 columns of
// the tile (wg::acc_row / acc_col). It adds b[col] in f32 to the f32 sum
// and scans its columns in ascending order, keeping a row's value only when
// it is strictly greater; the four threads of a quad (one row) then merge
// by shuffles, the larger value winning and, on equal values, the lower
// column. So each tile yields its rows' (max, first column of the max).
//
//  * K4, tile-parallel (head_tile_argmax_kernel + head_merge_kernel): one
//    block a tile, grid (ceil(V / 128), ceil(rows / 128)), two blocks an
//    SM (34 x 188 = 6,392 tiles at the flagship's size, ~24 waves). Each
//    tile writes its rows' (max, column) to a [ceil(V / 128), rows]
//    partials scratch (6.5 MB there); a second launch scans each row's
//    tiles in ascending order with strict greater, from (-inf, 0). No
//    atomics: two launches give the same bits.
//  * P2, in-block carry (head_chunk_carry_kernel): one block a 128-row
//    tile walks the vocabulary in 512-column chunks (the JAX probe's
//    V_CHUNK), each four 128-column tiles on the same mainloop with the
//    pipeline's k-block count running on across them. A chunk's (max, first
//    column) merges into the row's running pair only on a strictly greater
//    max. One launch, no scratch; 188 blocks at the flagship's size.
// Both form every logit the same way (the same k-blocks in the same order,
// from zero, then + b in f32), so P2's ids equal K4's on every row, and ties
// go to the first index, as jnp.argmax and the JAX kernels' strict
// per-chunk update give.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kBN = wg::kBN;
constexpr int kStages = 3;
constexpr int kBlocksPerSM = 2;
constexpr int kChunk = 512;  // P2's vocabulary chunk: four tiles
constexpr int kMergeThreads = 256;
constexpr int kNoColumn = 0x7fffffff;

// Fold this thread's columns of one tile (n0 .. n0 + 127) into its rows'
// (max, first column): acc holds the warpgroup's 64 x 128 product, bias b
// [V] f32; q = tid % 4. Columns are visited in ascending order; only a
// strictly greater value replaces the kept one.
__device__ __forceinline__ void scan_tile(const float (&acc)[64], const float* __restrict__ b,
                                          int n0, int V, int q, float (&m)[2], int (&mi)[2]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * q + e;  // wg::acc_col of acc[4j + 2h + e]
      if (col < V) {
        const float bv = __ldg(b + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // row half: wg::acc_row's + 8 * h
          const float v = acc[4 * j + 2 * h + e] + bv;
          if (v > m[h]) {
            m[h] = v;
            mi[h] = col;
          }
        }
      }
    }
}

// the quad's four (max, column) of one row -> the larger, the lower column
// on equal values (the same pair in all four threads)
__device__ __forceinline__ void quad_merge(float& m, int& mi) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
    if (om > m || (om == m && oi < mi)) {
      m = om;
      mi = oi;
    }
  }
}

// K4 launch 1: tile (blockIdx.x, blockIdx.y) -> partials[blockIdx.x][row] =
// (max bits, first column) of its rows. x [M, d] and w [d, V] bf16 through
// tx / tw; b [V] f32.
__global__ void __launch_bounds__(wg::kThreads, kBlocksPerSM)
head_tile_argmax_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                        int2* __restrict__ partials, int M, int V, int kblocks) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const wg::Pipeline<kStages> pipe(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * wg::kBM;
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (threadIdx.x >= wg::kConsumerThreads) {  // the producer warp
    if (threadIdx.x == wg::kConsumerThreads) pipe.produce(&tx, &tw, m0, n0, kblocks);
    return;
  }
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[kBN / 2];
  pipe.consume(acc, wgi, kblocks);
  float m[2] = {-INFINITY, -INFINITY};
  int mi[2] = {kNoColumn, kNoColumn};
  scan_tile(acc, b, n0, V, tid % 4, m, mi);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    quad_merge(m[h], mi[h]);
    const int row = m0 + wgi * 64 + wg::acc_row(tid, 2 * h);
    if (tid % 4 == 0 && row < M)
      partials[(size_t)blockIdx.x * M + row] = make_int2(__float_as_int(m[h]), mi[h]);
  }
}

// K4 launch 2: ids[row] = the column of the first strictly greatest of the
// row's tiles, scanned in ascending order from (-inf, 0)
__global__ void __launch_bounds__(kMergeThreads)
head_merge_kernel(const int2* __restrict__ partials, int* __restrict__ ids, int M, int tiles) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= M) return;
  float best = -INFINITY;
  int best_i = 0;
  for (int t = 0; t < tiles; ++t) {
    const int2 p = partials[(size_t)t * M + row];
    if (__int_as_float(p.x) > best) {
      best = __int_as_float(p.x);
      best_i = p.y;
    }
  }
  ids[row] = best_i;
}

// P2: block blockIdx.x owns rows m0 .. m0 + 127 and walks the vocabulary in
// 512-column chunks of four tiles, carrying each row's (max, argmax) from
// (-inf, 0), as the JAX probe's chunk loop does.
__global__ void __launch_bounds__(wg::kThreads, kBlocksPerSM)
head_chunk_carry_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                        int* __restrict__ ids, int M, int V, int kblocks) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const wg::Pipeline<kStages> pipe(smem_raw);
  const int m0 = blockIdx.x * wg::kBM, tiles = ceil_div(V, kBN);
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (threadIdx.x >= wg::kConsumerThreads) {  // the producer warp: every tile in turn
    if (threadIdx.x == wg::kConsumerThreads)
      for (int t = 0; t < tiles; ++t) pipe.produce(&tx, &tw, m0, t * kBN, kblocks, t * kblocks);
    return;
  }
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[kBN / 2];
  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {0, 0};
  for (int c0 = 0; c0 < V; c0 += kChunk) {
    float m[2] = {-INFINITY, -INFINITY};
    int mi[2] = {kNoColumn, kNoColumn};
    for (int n0 = c0; n0 < c0 + kChunk && n0 < V; n0 += kBN) {
      const int base = (n0 / kBN) * kblocks;
      pipe.consume(acc, wgi, kblocks, base);
      pipe.release_last(kblocks, base);
      scan_tile(acc, b, n0, V, tid % 4, m, mi);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      quad_merge(m[h], mi[h]);
      if (m[h] > best[h]) {  // strict: an earlier chunk keeps a tie
        best[h] = m[h];
        best_i[h] = mi[h];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wgi * 64 + wg::acc_row(tid, 2 * h);
    if (tid % 4 == 0 && row < M) ids[row] = best_i[h];
  }
}

// the tensor maps of x [M, d] (64 x 128 boxes) and w [d, V] with row pitch
// ldw (64 x 64 boxes), or false if the operands do not suit them
bool head_maps(CUtensorMap* tx, CUtensorMap* tw, const bf16* x, const bf16* w, int M, int d,
               int V, int ldw) {
  if (M <= 0 || d <= 0 || d % 16 || V <= 0 || ldw < V || ldw % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return false;
  return make_tmap_2d(tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, d, M, (uint64_t)d * sizeof(bf16),
                      wg::kBK, wg::kBM, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_tmap_2d(tw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, V, d,
                      (uint64_t)ldw * sizeof(bf16), 64, wg::kBK, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// K4: x [M, d] bf16, w [d, ldw] bf16 (columns >= V ignored), b [V] f32 ->
// ids [M] int32, with partials [ceil(V / 128)][M] int2 as scratch. d % 16
// == 0, ldw % 8 == 0, ldw >= V; x and w 16-byte aligned. Two launches.
extern "C" int jl_head_argmax(const bf16* x, const bf16* w, const float* b, int2* partials,
                              int* ids, int M, int d, int V, int ldw, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!head_maps(&tx, &tw, x, w, M, d, V, ldw) || ceil_div(M, wg::kBM) > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(kStages);
  cudaError_t err = cudaFuncSetAttribute(head_tile_argmax_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ceil_div(V, kBN);
  const dim3 grid(tiles, ceil_div(M, wg::kBM));
  head_tile_argmax_kernel<<<grid, wg::kThreads, smem, stream>>>(tx, tw, b, partials, M, V,
                                                               ceil_div(d, wg::kBK));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge_kernel<<<ceil_div(M, kMergeThreads), kMergeThreads, 0, stream>>>(partials, ids, M,
                                                                              tiles);
  return (int)cudaGetLastError();
}

// P2: the operands of jl_head_argmax without the scratch. One launch.
extern "C" int jl_head_argmax_chunked(const bf16* x, const bf16* w, const float* b, int* ids,
                                      int M, int d, int V, int ldw, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!head_maps(&tx, &tw, x, w, M, d, V, ldw)) return (int)cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(kStages);
  cudaError_t err = cudaFuncSetAttribute(head_chunk_carry_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_chunk_carry_kernel<<<ceil_div(M, wg::kBM), wg::kThreads, smem, stream>>>(
      tx, tw, b, ids, M, V, ceil_div(d, wg::kBK));
  return (int)cudaGetLastError();
}
