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
//  * gemm_kernel<EPI, ENTRY>: persistent, one block an SM walking 128 x 128
//    output tiles in row-major order (tile t, t + grid, ...: the blocks
//    together sweep whole rows of tiles, so an A row block serves every
//    column from L2 and the weights stay there). A producer warpgroup (one
//    thread issues every TMA load) keeps kDefaultStages k-blocks of 64 (fc1:
//    kGeluStages, beside its GELU table) in flight
//    across tiles; two consumer warpgroups take the block's tiles in turn,
//    each computing a whole tile (two wgmma m64n128k16 a k16 step, 128
//    f32 accumulators a thread under setmaxnreg 232) while the other runs
//    its epilogue, so the epilogue (bias, GELU, residual) overlaps the
//    other tile's products. Two named barriers order the warpgroups'
//    mainloops (one may start waiting on the shared stages only once the
//    other has issued its last products), which keeps each stage's barrier
//    phases unambiguous. The epilogue works in registers on the
//    accumulator layout, writes the bf16 tile into the warpgroup's own
//    128-byte-swizzled staging buffer, and one thread stores it by TMA
//    (rows past M are clipped); a residual tile comes into that buffer by
//    TMA during the mainloop. fc1's GELU (either form) is a table of the
//    form's own bf16 results, filled by each block at launch, read in a
//    second pass over the staged tile (common.cuh::gelu_lookup: the GELU's
//    input is a bf16 value, so a lookup gives the form's bits; computed
//    forms, tanhf or a guarded ex2 + rcp one, cost one warpgroup's
//    epilogue more than the other's products take, PERF.md), shared with
//    the producer warpgroup's three spare warps. Rows past M are read as
//    zeros. No split-K, no atomics: two launches
//    give the same bits, and each tile's sums run in the order of the
//    one-tile-a-block design before it, so the bits are that design's too.
// csrc/w8a8_mlp.cu's w8a8_tile_kernel (P4) is this GEMM's int8 twin, with
// the same producer loop and barrier protocol: a fix to one belongs in both.
// K5 is ln_rows + gemm<kBias> (N = 3D); K3 is ln_rows + gemm<kGelu*> (N =
// mlp, into a hidden scratch) + gemm<kResidual> (K = mlp); K2h-out is
// gemm<kResidual, kOutProj> alone; K2 is K5's two launches, the attention
// core, then gemm<kAttnResidual, kAttnOut>.
//
// Tensor parallelism (Megatron's row-parallel product) splits a sublayer at
// its last product: a rank holds wo[D / tp, D] or w2[mlp / tp, D] and
// computes a partial sum over its share of K, which the ranks add up before
// the bias and the residual are added once. gemm<kRowPartial, kRowOut>
// (jl_row_partial) is that partial: the same mainloop, and an epilogue that
// stores the f32 accumulator itself (no bias, no residual, no rounding), so
// the summed partials round once, as the one-card epilogue rounds its
// accumulator, up to the order of the f32 sums. Its tile (64 KB in f32)
// does not fit the staging buffers beside the stages, so each consumer
// thread stores its accumulator pairs straight to device memory (8-byte
// stores, four lanes a 32-byte row segment); rows past M are not stored.
// jl_ln_fc1 is K3's first two launches alone (ln_rows, fc1 + GELU on the
// rank's mlp / tp columns), the MLP's column-parallel half.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kBN = wg::kBN;
constexpr int kDefaultStages = 5;  // k-blocks in flight, shared by the block's tiles
constexpr int kGeluStages = 4;     // with the GELU's table beside them
// a producer warpgroup (one thread issues every load; setmaxnreg acts on
// whole warpgroups) and two consumer warpgroups, whose registers come from
// it: 2 x 232 + 40 <= 512 a thread slot of each SM quarter
constexpr int kGemmThreads = 3 * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kTileBytes = wg::kBM * kBN * 2;  // a staged bf16 output tile
constexpr uint32_t kHalfBytes = kTileBytes / 2;     // its 64 columns: one TMA box
// named barriers (0 is __syncthreads): consumer warpgroup w waits on
// kTurnBarrier + w before its tile's products; kEpiBarrier + w is its own
constexpr int kTurnBarrier = 2;
constexpr int kEpiBarrier = 4;
// fc1's GELU pass runs on a consumer warpgroup and on the producer
// warpgroup's three spare warps (96 threads): kGeluGoBarrier + w once
// warpgroup w's tile is staged, kGeluDoneBarrier + w once its GELU is done
constexpr int kGeluHelpers = 96;
constexpr int kGeluGoBarrier = 6;
constexpr int kGeluDoneBarrier = 8;

constexpr int kLnWarps = 8;    // rows per ln_rows block
constexpr int kLnMaxVecs = 8;  // 16-byte vectors a lane holds: d <= 8 x 32 x 8

enum Epilogue { kBias, kGeluTanh, kGeluErf, kResidual, kAttnResidual, kRowPartial };
// The C entry point an instance serves. It changes no code: K3's fc2 and
// K2h-out run the same epilogue, and a profile tells them apart only by the
// kernel's name (gemm_kernel<3, 0> against gemm_kernel<3, 1>; K2's
// out-projection is gemm_kernel<4, 2>; ln_rows_kernel<0> serves K5 and K2,
// ln_rows_kernel<1> K3).
enum Entry { kSublayer, kOutProj, kAttnOut, kRowOut };

// a block's dynamic shared memory, from a 1024-aligned base: the stages,
// the two warpgroups' staging tiles, the GELU's table (fc1 only), then the
// barriers
template <int EPI>
struct GemmLayout {
  static constexpr bool kGelu = EPI == kGeluTanh || EPI == kGeluErf;
  static constexpr int kStages = kGelu ? kGeluStages : kDefaultStages;
  static constexpr size_t kOut = (size_t)kStages * wg::kStageBytes;
  static constexpr size_t kTable = kOut + 2 * kTileBytes;
  static constexpr size_t kBar = kTable + (kGelu ? kGeluTableBytes : 0);
  static constexpr size_t kBytes = 1024 + kBar + (2 * kStages + 3) * sizeof(uint64_t);
};

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

// The tiles a block walks: t = blockIdx.x, blockIdx.x + gridDim.x, ... below
// `tiles`, the j-th of them (j from 0) to consumer warpgroup j % 2; tile t
// is rows (t / n_tiles) * 128 and columns (t % n_tiles) * 128 of the output.
// tests/test_torch_ln_gemm.py walks a twin of this schedule.
__device__ __forceinline__ void tile_origin(int t, int n_tiles, int& m0, int& n0) {
  m0 = (t / n_tiles) * wg::kBM;
  n0 = (t % n_tiles) * kBN;
}

// The GELU of a staged bf16 tile by its table, in place: 16-byte vectors
// first, first + stride, ... of the tile's 2,048 (row-major vectors of the
// staging swizzle), each thread's writes then fenced for the TMA store
__device__ __forceinline__ void gelu_pass(uint8_t* staged, const uint16_t* table, int first,
                                          int stride) {
#pragma unroll 2
  for (int v = first; v < (int)(kTileBytes / 16); v += stride) {
    const int row = (v % 1024) / 8, chunk = v % 8;
    uint4* at = reinterpret_cast<uint4*>(staged + (v / 1024) * kHalfBytes + row * 128 +
                                         ((chunk ^ (row & 7)) * 16));
    uint4 hv = *at;
    uint16_t* e = reinterpret_cast<uint16_t*>(&hv);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = gelu_lookup(table, e[k]);
    *at = hv;
  }
  fence_proxy_async();
}

// out [M, N] = epilogue(a [M, K] . w [K, N]) for bf16 a, w (row-major, w
// as [in, out]), bias [N] bf16, res [M, N] bf16 (kResidual and
// kAttnResidual only; tres maps it, tout maps out, both with 64 x 128
// boxes and the 128-byte swizzle); kRowPartial writes the f32 product to
// out32 [M, N] instead and reads neither bias nor res nor tout
template <int EPI, int ENTRY>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tres, const __grid_constant__ CUtensorMap tout,
            const bf16* __restrict__ bias, float* __restrict__ out32, int M, int N, int K) {
  using L = GemmLayout<EPI>;
  constexpr int kStages = L::kStages;
  constexpr bool kHasResidual = EPI == kResidual || EPI == kAttnResidual;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint16_t* table = reinterpret_cast<uint16_t*>(base + L::kTable);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;  // one a consumer warpgroup
  uint64_t* done = res_full + 2;         // the consumers' last arrival
  const int n_tiles = N / kBN, tiles = n_tiles * ceil_div(M, wg::kBM);
  const int kblocks = K / wg::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 1);  // the arrival of the warpgroup that read it
    }
    mbar_init(&res_full[0], 1);
    mbar_init(&res_full[1], 1);
    mbar_init(done, 2);
    fence_barrier_init();
  }
  if constexpr (L::kGelu) gelu_table_fill(table, EPI == kGeluErf, threadIdx.x, kGemmThreads);
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int g = 0;  // the block's running k-block count: stage g % kStages
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, n_tiles, m0, n0);
        for (int kb = 0; kb < kblocks; ++kb, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(&empty[s], ((g / kStages) - 1) & 1);
          uint8_t* a = base + (size_t)s * wg::kStageBytes;
          mbar_arrive_expect_tx(&full[s], wg::kStageBytes);
          tma_load_2d(a, &ta, kb * wg::kBK, m0, &full[s]);
          tma_load_2d(a + wg::kABytes, &tw, n0, kb * wg::kBK, &full[s]);
          tma_load_2d(a + wg::kABytes + wg::kBSlabBytes, &tw, n0 + 64, kb * wg::kBK, &full[s]);
        }
      }
      // the consumers wait untimed (a trap in their region would hold them
      // to the entry register count): a stall traps here instead
      mbar_wait(done, 0);
    } else if (L::kGelu && threadIdx.x >= 2 * 128 + 32) {
      // warps 9-11: their share of each tile's GELU pass, in the block's
      // tile order (warpgroup j % 2's j-th tile)
      const int first = 128 + threadIdx.x - (2 * 128 + 32);
      for (int j = 0, t = blockIdx.x; t < tiles; ++j, t += gridDim.x) {
        wg::named_sync(kGeluGoBarrier + (j & 1), 128 + kGeluHelpers);
        gelu_pass(base + L::kOut + (j & 1) * kTileBytes, table, first, 128 + kGeluHelpers);
        wg::named_sync(kGeluDoneBarrier + (j & 1), 128 + kGeluHelpers);
      }
    }
    return;
  }

  // a consumer warpgroup: tiles j = wgi, wgi + 2, ... of the block
  wg::reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const bool leader = tid == 0;
  uint8_t* stage_out = base + L::kOut + wgi * kTileBytes;
  float acc[2][kBN / 2];  // rows 0-63 and 64-127 of the tile
  int mine = 0;           // this warpgroup's tiles so far
  for (int j = wgi, t = blockIdx.x + wgi * gridDim.x; t < tiles;
       j += 2, t += 2 * gridDim.x, ++mine) {
    int m0, n0;
    tile_origin(t, n_tiles, m0, n0);
    // the other warpgroup has passed every stage wait of the tile before
    if (j > 0) wg::named_sync(kTurnBarrier + wgi, 256);
    for (int kb = 0; kb < kblocks; ++kb) {
      const int g = j * kblocks + kb, s = g % kStages;
      mbar_wait_untimed(&full[s], (g / kStages) & 1);
      const uint32_t a0 = smem_u32(base + (size_t)s * wg::kStageBytes);
      const uint32_t b0 = a0 + wg::kABytes;
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < wg::kBK / 16; ++k) {
        const uint64_t db = wg::desc_sw128(b0 + 2048 * k, wg::kBSlabBytes, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wg::mma<1>(acc[h], wg::desc_sw128(a0 + h * 64 * 128 + 32 * k, 16, 1024), db,
                     kb > 0 || k > 0);
      }
      wg::wgmma_commit();
      if (kHasResidual && kb == 0 && leader) {
        // the residual tile into the staging buffer, once the last store
        // from it has read it
        bulk_wait_read<0>();
        mbar_arrive_expect_tx(&res_full[wgi], kTileBytes);
        tma_load_2d(stage_out, &tres, n0, m0, &res_full[wgi]);
        tma_load_2d(stage_out + kHalfBytes, &tres, n0 + 64, m0, &res_full[wgi]);
      }
      wg::wgmma_wait<1>();  // the previous stage's products are done with it
      if (kb > 0 && leader) mbar_arrive(&empty[(g - 1) % kStages]);
    }
    // the block's next tile is the other warpgroup's: let it start
    if (t + (int)gridDim.x < tiles) wg::named_arrive(kTurnBarrier + (1 - wgi), 256);
    wg::wgmma_wait<0>();
    wg::fence_operand(acc[0]);
    wg::fence_operand(acc[1]);
    if (leader) mbar_arrive(&empty[(j * kblocks + kblocks - 1) % kStages]);

    if constexpr (EPI == kRowPartial) {
      // the f32 accumulator as it is: adjacent column pairs (i, i + 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = m0 + h * 64;
#pragma unroll
        for (int i = 0; i < kBN / 2; i += 2) {
          const int r = r0 + wg::acc_row(tid, i);
          if (r < M)
            *reinterpret_cast<float2*>(out32 + (size_t)r * N + n0 + wg::acc_col(tid, i)) =
                make_float2(acc[h][i], acc[h][i + 1]);
        }
      }
      continue;
    }

    // the epilogue, while the other warpgroup's products run
    float2 bcol[kBN / 8];  // the bias at this thread's column pairs
#pragma unroll
    for (int c8 = 0; c8 < kBN / 8; ++c8)
      bcol[c8] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          bias + n0 + wg::acc_col(tid, 4 * c8)));
    if (leader) bulk_wait_read<0>();  // the last store has read the buffer
    wg::named_sync(kEpiBarrier + wgi, 128);
    if constexpr (kHasResidual) mbar_wait_untimed(&res_full[wgi], mine & 1);
    // the element pair (i, i + 1) of half h: its word in the staging tile
    // (the 128-byte swizzle of the TMA boxes)
    auto staged = [&](int h, int i) {
      const int r = h * 64 + wg::acc_row(tid, i), c = wg::acc_col(tid, i);
      return reinterpret_cast<uint32_t*>(stage_out + (c / 64) * kHalfBytes + r * 128 +
                                         ((((c % 64) / 8) ^ (r & 7)) * 16) + (c % 8) * 2);
    };
    // on the accumulator layout: the rounded product, + bias (the GELU's
    // input for fc1), + x for the residual forms
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) {
        uint32_t* at = staged(h, i);
        const float2 b = bcol[i >> 2];
        float v0 = round_bf16(acc[h][i]), v1 = round_bf16(acc[h][i + 1]);
        if constexpr (EPI == kBias || EPI == kGeluTanh || EPI == kGeluErf) {
          v0 += b.x;
          v1 += b.y;
        } else {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
          if constexpr (EPI == kAttnResidual) {
            v0 = round_bf16(x.x + v0) + b.x;
            v1 = round_bf16(x.y + v1) + b.y;
          } else {
            v0 = x.x + round_bf16(v0 + b.x);
            v1 = x.y + round_bf16(v1 + b.y);
          }
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        *at = *reinterpret_cast<const uint32_t*>(&o);
      }
    }
    if constexpr (L::kGelu) {
      // the GELU of the staged bf16 h by its table, shared with the three
      // spare warps (on the accumulator layout the registers ran out and
      // each lookup's latency showed; one warpgroup alone took longer than
      // the other's products)
      wg::named_sync(kGeluGoBarrier + wgi, 128 + kGeluHelpers);
      gelu_pass(stage_out, table, tid, 128 + kGeluHelpers);
      wg::named_sync(kGeluDoneBarrier + wgi, 128 + kGeluHelpers);
    }
    fence_proxy_async();
    wg::named_sync(kEpiBarrier + wgi, 128);
    if (leader) {
      tma_store_2d(&tout, n0, m0, stage_out);
      tma_store_2d(&tout, n0 + 64, m0, stage_out + kHalfBytes);
      bulk_commit();
    }
  }
  if (leader) {
    bulk_wait<0>();
    mbar_arrive(done);
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

// a [rows, cols] bf16 tensor (row pitch cols) in 64-column x 128-row boxes
bool tile_map(CUtensorMap* map, const bf16* p, int rows, int cols, uint32_t box_rows) {
  return make_tmap_2d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, rows,
                      (uint64_t)cols * sizeof(bf16), 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int EPI, int ENTRY = kSublayer>
int gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* res, bf16* out, int M,
         int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN || K % wg::kBK) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw, tres, tout;
  if (!make_tmap_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, (uint64_t)K * sizeof(bf16),
                    wg::kBK, wg::kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&tw, w, K, N, wg::kBK) || !tile_map(&tout, out, M, N, wg::kBM) ||
      !tile_map(&tres, res ? res : out, M, N, wg::kBM))
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once an instance and device
  static int opted_in = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (opted_in != dev) {
    err = cudaFuncSetAttribute(gemm_kernel<EPI, ENTRY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GemmLayout<EPI>::kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = dev;
  }
  const int tiles = (N / kBN) * ceil_div(M, wg::kBM), sms = sm_count();
  gemm_kernel<EPI, ENTRY><<<tiles < sms ? tiles : sms, kGemmThreads, GemmLayout<EPI>::kBytes,
                            stream>>>(
      ta, tw, tres, tout, bias, nullptr, M, N, K);
  return (int)cudaGetLastError();
}

// the row-parallel partial: out [M, N] f32 = a [M, K] . w [K, N] (bf16)
int row_partial(const bf16* a, const bf16* w, float* out, int M, int N, int K,
                cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN || K % wg::kBK) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  if (!make_tmap_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, (uint64_t)K * sizeof(bf16),
                    wg::kBK, wg::kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&tw, w, K, N, wg::kBK))
    return (int)cudaErrorInvalidValue;
  static int opted_in = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (opted_in != dev) {
    err = cudaFuncSetAttribute(gemm_kernel<kRowPartial, kRowOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GemmLayout<kRowPartial>::kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = dev;
  }
  const int tiles = (N / kBN) * ceil_div(M, wg::kBM), sms = sm_count();
  // tres and tout are never read by this epilogue: ta stands in for them
  gemm_kernel<kRowPartial, kRowOut><<<tiles < sms ? tiles : sms, kGemmThreads,
                                      GemmLayout<kRowPartial>::kBytes, stream>>>(
      ta, tw, ta, ta, nullptr, out, M, N, K);
  return (int)cudaGetLastError();
}

// every bf16 value through K3's GELUs as fc1's epilogue takes them (the
// table lookup) and as the forms give them: out [4][n] = lookup of
// gelu_tanh, gelu_tanh, lookup of gelu_erf, gelu_erf (bf16)
__global__ void gelu_check_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int n) {
  __shared__ uint16_t tables[2][2 * kGeluSpan];
  gelu_table_fill(tables[0], 0, threadIdx.x, blockDim.x);
  gelu_table_fill(tables[1], 1, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint16_t b = __bfloat16_as_ushort(in[i]);
  const float h = __bfloat162float(in[i]);
  out[i] = __ushort_as_bfloat16(gelu_lookup(tables[0], b));
  out[n + i] = __float2bfloat16(gelu_tanh(h));
  out[2 * n + i] = __ushort_as_bfloat16(gelu_lookup(tables[1], b));
  out[3 * n + i] = __float2bfloat16(gelu_erf(h));
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

// The row-parallel partial of a tensor-parallel sublayer: a [M, K] bf16 (a
// rank's heads' outputs or hidden columns), w [K, N] bf16 (its rows of wo or
// w2) -> out [M, N] f32 = a . w, the accumulator unrounded (no bias, no
// residual: both are added once, after the ranks' partials are summed).
// K % 64 == 0, N % 128 == 0; pointers 16-byte aligned.
extern "C" int jl_row_partial(const bf16* a, const bf16* w, float* out, int M, int N, int K,
                              cudaStream_t stream) {
  return row_partial(a, w, out, M, N, K, stream);
}

// K3's first two launches alone, the column-parallel half of a
// tensor-parallel MLP: x [M, d] bf16, g / bl [d] f32, w1 [d, mlp] and b1
// [mlp] bf16 (a rank's columns) -> h [M, mlp] = bf16(GELU(bf16(bf16(LN(x) .
// w1) + b1))), with ln [M, d] bf16 as scratch. d % 64 == 0, d <= 2048, mlp
// % 128 == 0; pointers 16-byte aligned.
extern "C" int jl_ln_fc1(const bf16* x, const float* g, const float* bl, const bf16* w1,
                         const bf16* b1, bf16* ln, bf16* h, int M, int d, int mlp, int erf_form,
                         float eps, cudaStream_t stream) {
  const int err = ln_rows<1>(x, g, bl, ln, M, d, eps, stream);
  if (err) return err;
  return erf_form ? gemm<kGeluErf>(ln, w1, b1, nullptr, h, M, mlp, d, stream)
                  : gemm<kGeluTanh>(ln, w1, b1, nullptr, h, M, mlp, d, stream);
}

// K3's GELUs checked over their inputs: in [n] bf16 -> out [4, n] bf16
// (the table lookup of gelu_tanh, gelu_tanh, the lookup of gelu_erf,
// gelu_erf)
extern "C" int jl_gelu_check(const bf16* in, bf16* out, int n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  gelu_check_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// One GEMM launch alone, the instance K5, K3 or K2 runs: epi 0 the q/k/v
// product + bias, 1 fc1 + tanh GELU, 2 fc1 + erf GELU, 3 fc2 + bias + x, 4
// K2's out-projection (x + the product, then + bias); res [M, N] for 3 and
// 4 only. For timing each launch apart (chip_smoke.py).
extern "C" int jl_gemm(int epi, const bf16* a, const bf16* w, const bf16* bias, const bf16* res,
                       bf16* out, int M, int N, int K, cudaStream_t stream) {
  switch (epi) {
    case 0: return gemm<kBias>(a, w, bias, nullptr, out, M, N, K, stream);
    case 1: return gemm<kGeluTanh>(a, w, bias, nullptr, out, M, N, K, stream);
    case 2: return gemm<kGeluErf>(a, w, bias, nullptr, out, M, N, K, stream);
    case 3: return gemm<kResidual>(a, w, bias, res, out, M, N, K, stream);
    case 4: return gemm<kAttnResidual, kAttnOut>(a, w, bias, res, out, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
