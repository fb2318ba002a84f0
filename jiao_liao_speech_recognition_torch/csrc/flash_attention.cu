// K6: flash attention forward with log-sum-exp; K8: its backward (dQ; dK, dV);
// and K2's attention core (jl_attention_core, below the backward).
//
// Replaces ops/flash_attention.py of the JAX package: _flash_kernel and
// _flash_kernel_lse (flash_attention, and the vjp forward of
// flash_attention_packed; its inference-only _packed_flash_kernel computes
// the same function), and _flash_bwd_dq_kernel + _flash_bwd_dkv_kernel
// (_flash_backward). q, k, v are [B, T, H, dh] given by batch and time
// strides (head stride dh, unit element stride), so the head-packed
// [B, T, H*dh] layout of flash_attention_packed is the same bytes and needs
// no fold or transpose. dh is a template parameter (64, 128).
//
// Semantics kept from the JAX kernels: scale 1/sqrt(dh); keys at or past
// kv_len[b] (and, causal, keys after the query) are masked with -1e30; key
// tiles past kv_len are skipped, so an empty row gives out = 0
// (acc / max(l, 1e-30)) and lse = m + log(max(l, 1e-30)) with m = -1e30;
// the backward rebuilds P = exp(s - max(lse, -1e29)) on valid keys only,
// takes delta = rowsum(dO * O) and forms dQ = (P o (dP - delta)) K scale,
// dV = P^T dO, dK = (P o (dP - delta))^T Q scale. Keys past kv_len get
// exactly-zero dK and dV.
// One deviation, on purpose: the forward rounds P to bf16 before P.V, its
// tensor-core operand, where the TPU kernel keeps P in f32; the plain
// version (ops/flash_attention.py::flash_forward_plain) rounds P the same
// way, and the sums stay f32. The backward keeps the TPU kernel's f32
// operands in effect: P (for dV = P^T dO) and dS (for dQ = dS K and
// dK = dS^T Q) enter their products as a pair of bf16 values, hi = bf16(x)
// and lo = bf16(x - hi), two products into one accumulator, which carries
// them to ~2^-16. A single rounding is not enough there: each row of dS
// sums to zero (sum_j P_j (dP_j - delta) = 0) and dO changes sign along the
// queries, so these products are small differences of large terms.
//
// What bounds it on the H100: tensor-core work. Over `pairs` valid
// query-key pairs the forward needs 4 H dh pairs flops (S = Q K^T, O = P V)
// and the backward 10 H dh pairs (S, dP, dQ, dK, dV); at B=16, T=750, 8 x 64
// that is 18.4 and 46 GFLOP over 25 and 50 MB, far above the card's 295
// flop/byte ridge. This backward executes 20 H dh pairs: each launch forms
// S and dP itself (two launches, so no atomics and a repeatable result),
// and the three products with P or dS as operand run twice (hi and lo).
// So the design has to win on rate:
//
//  * Every product is a wgmma (sm_90a) on operands that TMA brings into
//    128-byte-swizzled shared memory through mbarrier-counted stages; no
//    operand passes through registers on its way in, and no transposed copy
//    is made. K as stored ([key][dh], dh contiguous) is the K-major B of
//    S = Q K^T; V, dO, Q and K as B of a "P times rows" product
//    (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K) are N-major and are
//    read through the descriptor with imm-trans-b = 1. P and dS never leave
//    registers: a score accumulator is, element for element, the register-A
//    fragment of the next product (csrc/wgmma_gemm.cuh).
//  * Roles: one thread of a producer warpgroup issues every copy (4-D
//    tensor maps over the strided [B, T, H, dh] views, boxes of 64 columns
//    x 64 rows; dh = 128 is two column boxes; TMA fills rows past T with
//    zeros) into a ring of kStages stages with full and empty barriers, and
//    the warpgroup gives its registers to two consumer warpgroups
//    (setmaxnreg 40 / 232). Each consumer warpgroup owns 64 of the block's
//    128 rows, so both share every streamed tile, and each warpgroup's
//    softmax runs while the other's products occupy the tensor cores. One
//    block an SM.
//  * jl_flash_fwd: one block per (128 queries, b*h); key tiles of kFwdKeys
//    (128 ran faster than 64 at T=1500, 20 x 64, on the H100);
//    online softmax in registers on exp2 of scores pre-scaled by
//    scale*log2(e), row statistics reduced over the quad with shuffles;
//    out staged in the Q tile's shared memory and stored in 16-byte pieces.
//  * jl_flash_bwd, two launches: (1) per (128 queries, b*h): delta read as
//    16-byte vectors of O and dO, then dQ over 64-key tiles; it also writes
//    each row's base-2 lse and delta to a padded scratch [B*H, 2, Tp]
//    (Tp = Tq rounded up to 128) that (2) streams with bulk copies;
//    (2) per (128 keys, b*h): dK and dV over 64-query tiles, accumulators
//    in the consumers' registers. Every sum runs in a fixed order.
//  * Tile skipping: tiles wholly past kv_len, or past the diagonal when
//    causal, are never loaded; the producer issues exactly the tiles that
//    the consumers wait for. Masks are applied in registers only on tiles
//    that cut kv_len, Tq or the diagonal.
//  * A stall fails the launch: barrier waits trap after 4 s (csrc/tma.cuh).
//    A trap in the consumers' code holds them to the entry register count
//    (168 = 65536 / 384) whatever setmaxnreg grants, which the backward's
//    consumers outgrow (ptxas then spills and serializes their wgmmas). So
//    there the consumers wait untimed, and the issuing thread, after its
//    last copy, waits timed on a barrier that they arrive at when done. The
//    forward keeps its consumers' waits timed: at dh = 64 it fits in 168,
//    and on an H100 at both of its timed shapes it ran 2-5% slower with the
//    backward's scheme and 1-3% slower without its setmaxnreg (which ptxas
//    then allocates 154 registers under) than as it is (PERF.md).
//    Its dh = 128 instance spills 56 bytes so.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;
using wg::desc_sw128;

constexpr int kRows = 128;     // rows a block owns: 64 for each consumer warpgroup
constexpr int kBox = 64;       // rows of a TMA box and of a streamed backward tile
constexpr int kFwdKeys = 128;  // keys of a forward tile (the N of S = Q K^T)
constexpr int kStages = 2;     // streamed tiles in flight
constexpr int kConsumers = 256;
// + a producer warpgroup, of which one thread issues every copy: setmaxnreg
// acts on whole warpgroups (with a lone producer warp, 288 threads, the
// consumers' setmaxnreg.inc never returned on the H100)
constexpr int kBlockThreads = kConsumers + 128;
// setmaxnreg budgets: each of the SM's four register files holds two
// consumer warps and one producer warp of the block: 2 x 232 + 40 <= 512
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float NEG = -1e30f;
constexpr float LSE_FLOOR = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;

// A tile of `rows` rows x DH bf16 lives in shared memory as DH / 64 chunks
// of rows x 128 bytes, each filled by 64-row TMA boxes with the 128-byte
// swizzle: row r of chunk c at c * chunk_bytes(rows) + r * 128.
__host__ __device__ constexpr uint32_t chunk_bytes(int rows) { return (uint32_t)rows * 128; }
template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)rows * DH * 2;
}

// K-major operand: 64 (A) or N (B) rows from row r0 of a tile, k16 step kk of DH
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  return desc_sw128(tile + (kk / 4) * chunk_bytes(rows) + r0 * 128 + (kk % 4) * 32, 16, 1024);
}

// N-major B (imm-trans-b = 1): tile rows [16 kk, 16 kk + 16) as the product's
// k, all DH columns as its N (64-column chunks chunk_bytes apart)
__device__ __forceinline__ uint64_t desc_n(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 2048, chunk_bytes(rows), 1024);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t raw = smem_u32(p);
  return p + (((raw + 1023) & ~1023u) - raw);
}

// producer: rows [t0, t0 + rows) of head h, batch b into a tile
template <int DH>
__device__ __forceinline__ void load_tile(uint8_t* dst, int rows, const CUtensorMap* map, int h,
                                          int t0, int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
    for (int r = 0; r < rows; r += kBox)
      tma_load_4d(dst + c * chunk_bytes(rows) + r * 128, map, c * 64, h, t0 + r, b, bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16 pair, lo = bf16 pair of the remainders
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The k16 block kk of a score accumulator (64 rows x N) as a register A:
// the bf16 pairs (8kk, 8kk+1), (8kk+2, 8kk+3), (8kk+4, 8kk+5), (8kk+6, 8kk+7)
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}
template <int N>
__device__ __forceinline__ void split_a(const float (&s)[N], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], hi[e], lo[e]);
}

// Writes a consumer warpgroup's 64 x DH accumulator (times `mul`, rounded to
// bf16) to rows [t0 + r0, t0 + r0 + 64) of a contiguous [B, T, H, DH] tensor,
// staged through its own rows [r0, r0 + 64) of a shared tile of `rows` rows
// that nothing else reads any more (16-byte pieces, swizzled by row so the
// staging writes do not conflict).
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2], float mul, uint8_t* tile,
                                           int rows, int r0, int w, bf16* __restrict__ dst, int b,
                                           int T, int H, int h, int t0) {
  const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  fence_proxy_async();
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = r0 + (tid / 32) * 16 + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t;
    uint8_t* at = tile + (col / 64) * chunk_bytes(rows) + row * 128 +
                  ((((col % 64) / 8) ^ (row & 7)) * 16) + (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
  wg::named_sync(1 + w, 128);
  constexpr int kPieces = DH / 8;  // 16-byte pieces a row
  for (int v = tid; v < 64 * kPieces; v += 128) {
    const int row = r0 + v / kPieces, p = v % kPieces, tt = t0 + row;
    if (tt >= T) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (p / 8) * chunk_bytes(rows) + row * 128 + (((p % 8) ^ (row & 7)) * 16));
    *reinterpret_cast<uint4*>(dst + (((size_t)b * T + tt) * H + h) * DH + p * 8) = val;
  }
}

// ----------------------------------------------------------------- forward

template <int DH>
struct FwdSmem {
  static constexpr uint32_t kQ = tile_bytes<DH>(kRows);
  static constexpr uint32_t kKV = tile_bytes<DH>(kFwdKeys);  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr size_t kBytes = 1024 + kQ + kStages * kStage + (1 + 2 * kStages) * 8;
};

template <int DH>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ lens,
                 bf16* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                 int causal, float scale) {
  using L = FwdSmem<DH>;
  constexpr int BN = kFwdKeys;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* st = qs + L::kQ;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(st + kStages * L::kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int kv_len = max(0, min(lens[b], Tk));
  int n_tiles = ceil_div(kv_len, BN);
  if (causal) n_tiles = min(n_tiles, ceil_div(q0 + kRows, BN));
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(qbar, L::kQ);
      load_tile<DH>(qs, kRows, &tq, h, q0, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], L::kStage);
        load_tile<DH>(st + s * L::kStage, BN, &tk, h, j * BN, b, &full[s]);
        load_tile<DH>(st + s * L::kStage + L::kKV, BN, &tv, h, j * BN, b, &full[s]);
      }
    }
  } else {  // the two consumer warpgroups (warps 0-7)
    wg::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
    // this thread's rows in the block: wrow and wrow + 8
    const int t = tid % 4, wrow = w * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    const float c = scale * kLog2e;
    const uint32_t qa = smem_u32(qs);
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // raw-score max, per-thread partial sums

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, k0 = j * BN;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint32_t ks = smem_u32(st + s * L::kStage), vs = ks + L::kKV;
      float sc[BN / 2];
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wg::mma<0>(sc, desc_k(qa, kRows, w * 64, kk), desc_k(ks, BN, 0, kk), kk > 0);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();

      if (k0 + BN > kv_len || (causal && k0 + BN - 1 > q0 + w * 64)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int q = q0 + wrow + 8 * ((i >> 1) & 1);
          if (key >= kv_len || (causal && key > q)) sc[i] = NEG;
        }
      }
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        alpha[r] = exp2f((m[r] - mt[r]) * c);
        m[r] = mt[r];
        mc[r] = mt[r] * c;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], c, -mc[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(sc, kk, pa[kk]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wg::mma<1>(o, pa[kk], desc_n(vs, BN, kk));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= inv[(i >> 1) & 1];
    store_rows<DH>(o, 1.f, qs, kRows, w * 64, w, out, b, Tq, H, h, q0);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + wrow + 8 * r;
        const float mn = m[r] <= NEG ? NEG : m[r] * scale;
        if (q < Tq) lse[(size_t)bh * Tq + q] = mn + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

// --------------------------------------------------------- backward: dQ

template <int DH>
struct DqSmem {
  static constexpr uint32_t kQ = tile_bytes<DH>(kRows);  // the Q and the dO tile
  static constexpr uint32_t kKV = tile_bytes<DH>(kBox);  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr size_t kBytes =
      1024 + 2 * kQ + kStages * kStage + 2 * kRows * sizeof(float) + (2 + 2 * kStages) * 8;
};

// also writes stats[bh][0][q] = max(lse, -1e29) * log2(e) and
// stats[bh][1][q] = delta = rowsum(dO * O) for q < Tp (0 past Tq) for the
// dK / dV launch
template <int DH>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const int* __restrict__ lens,
                    bf16* __restrict__ dq, float* __restrict__ stats, int H, int Tq, int Tk,
                    int Tp, int causal, float scale) {
  using L = DqSmem<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* dos = qs + L::kQ;
  uint8_t* st = dos + L::kQ;
  float* rows_s = reinterpret_cast<float*>(st + kStages * L::kStage);  // [2][kRows]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(rows_s + 2 * kRows);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // the consumers' last arrival

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int kv_len = max(0, min(lens[b], Tk));
  int n_tiles = ceil_div(kv_len, kBox);
  if (causal) n_tiles = min(n_tiles, ceil_div(q0 + kRows, kBox));
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(done, 2);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(qbar, 2 * L::kQ);
      load_tile<DH>(qs, kRows, &tq, h, q0, b, qbar);
      load_tile<DH>(dos, kRows, &tdo, h, q0, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], L::kStage);
        load_tile<DH>(st + s * L::kStage, kBox, &tk, h, j * kBox, b, &full[s]);
        load_tile<DH>(st + s * L::kStage + L::kKV, kBox, &tv, h, j * kBox, b, &full[s]);
      }
      mbar_wait(done, 0);  // the consumers' waits are untimed: a stall traps here
    }
  } else {  // the two consumer warpgroups (warps 0-7)
    wg::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int t = tid % 4, wrow = w * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    const float c = scale * kLog2e;

    {  // delta and the base-2 lse of this warpgroup's 64 rows: two threads a row
      const int row = w * 64 + tid / 2, half = tid % 2, q = q0 + row;
      float acc = 0.f;
      if (q < Tq) {
        const size_t at = (((size_t)b * Tq + q) * H + h) * DH + half * (DH / 2);
        const uint4* ov = reinterpret_cast<const uint4*>(o + at);
        const uint4* dv = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int v = 0; v < DH / 16; ++v) {
          const uint4 a = ov[v], d = dv[v];
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(a2[e]), fd = __bfloat1622float2(d2[e]);
            acc = fmaf(fa.x, fd.x, acc);
            acc = fmaf(fa.y, fd.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const float l2 = q < Tq ? fmaxf(lse[(size_t)bh * Tq + q], LSE_FLOOR) * kLog2e : 0.f;
        rows_s[row] = l2;
        rows_s[kRows + row] = acc;
        stats[(size_t)bh * 2 * Tp + q] = l2;
        stats[((size_t)bh * 2 + 1) * Tp + q] = acc;
      }
    }
    wg::named_sync(1 + w, 128);
    const float lr[2] = {rows_s[wrow], rows_s[wrow + 8]};
    const float dr[2] = {rows_s[kRows + wrow], rows_s[kRows + wrow + 8]};
    const uint32_t qa = smem_u32(qs), da = smem_u32(dos);
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    mbar_wait_untimed(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, k0 = j * kBox;
      mbar_wait_untimed(&full[s], (j / kStages) & 1);
      const uint32_t ks = smem_u32(st + s * L::kStage), vs = ks + L::kKV;
      float sc[kBox / 2], dp[kBox / 2];
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wg::mma<0>(sc, desc_k(qa, kRows, w * 64, kk), desc_k(ks, kBox, 0, kk), kk > 0);
        wg::mma<0>(dp, desc_k(da, kRows, w * 64, kk), desc_k(vs, kBox, 0, kk), kk > 0);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();

      const bool edge = k0 + kBox > kv_len || (causal && k0 + kBox - 1 > q0 + w * 64);
#pragma unroll
      for (int i = 0; i < kBox / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], c, -lr[r]));
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1), q = q0 + wrow + 8 * r;
          if (key >= kv_len || (causal && key > q)) p = 0.f;
        }
        sc[i] = p * (dp[i] - dr[r]);  // dS
      }
      uint32_t hi[kBox / 16][4], lo[kBox / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) split_a(sc, kk, hi[kk], lo[kk]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        wg::mma<1>(acc, hi[kk], desc_n(ks, kBox, kk));
        wg::mma<1>(acc, lo[kk], desc_n(ks, kBox, kk));
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    store_rows<DH>(acc, scale, qs, kRows, w * 64, w, dq, b, Tq, H, h, q0);
    if (tid == 0) mbar_arrive(done);
  }
}

// ----------------------------------------------------- backward: dK, dV

template <int DH>
struct DkvSmem {
  static constexpr uint32_t kKV = tile_bytes<DH>(kRows);  // the K and the V tile
  static constexpr uint32_t kQ = tile_bytes<DH>(kBox);    // one Q or dO tile
  static constexpr uint32_t kStage = 2 * kQ;
  static constexpr uint32_t kStats = 2 * kBox * sizeof(float);  // its lse and delta
  static constexpr size_t kBytes =
      1024 + 2 * kKV + kStages * (kStage + kStats) + (2 + 2 * kStages) * 8;
};

template <int DH>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ stats,
                     const int* __restrict__ lens, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int Tq, int Tk, int Tp, int causal, float scale) {
  using L = DkvSmem<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ks = align_1024(smem_raw);
  uint8_t* vs = ks + L::kKV;
  uint8_t* st = vs + L::kKV;
  float* stats_s = reinterpret_cast<float*>(st + kStages * L::kStage);  // [kStages][2][kBox]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(stats_s + kStages * 2 * kBox);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // the consumers' last arrival

  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kRows;
  const int kv_len = max(0, min(lens[b], Tk));
  const int i0 = causal ? k0 / kBox : 0;  // the first query tile that sees these keys
  const int n_tiles = k0 < kv_len ? max(0, ceil_div(Tq, kBox) - i0) : 0;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(done, 2);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(kvbar, 2 * L::kKV);
      load_tile<DH>(ks, kRows, &tk, h, k0, b, kvbar);
      load_tile<DH>(vs, kRows, &tv, h, k0, b, kvbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, q0 = (i0 + j) * kBox;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], L::kStage + L::kStats);
        load_tile<DH>(st + s * L::kStage, kBox, &tq, h, q0, b, &full[s]);
        load_tile<DH>(st + s * L::kStage + L::kQ, kBox, &tdo, h, q0, b, &full[s]);
        float* dst = stats_s + s * 2 * kBox;
        bulk_load(dst, stats + (size_t)bh * 2 * Tp + q0, kBox * sizeof(float), &full[s]);
        bulk_load(dst + kBox, stats + ((size_t)bh * 2 + 1) * Tp + q0, kBox * sizeof(float),
                  &full[s]);
      }
      mbar_wait(done, 0);  // the consumers' waits are untimed: a stall traps here
    }
  } else {  // the two consumer warpgroups (warps 0-7)
    wg::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
    // this thread's keys: k0 + wrow and k0 + wrow + 8
    const int t = tid % 4, wrow = w * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    const float c = scale * kLog2e;
    const uint32_t ka = smem_u32(ks), va = smem_u32(vs);
    float adk[DH / 2], adv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) adk[i] = adv[i] = 0.f;

    mbar_wait_untimed(kvbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, q0 = (i0 + j) * kBox;
      mbar_wait_untimed(&full[s], (j / kStages) & 1);
      const uint32_t qs = smem_u32(st + s * L::kStage), dos = qs + L::kQ;
      const float* l2 = stats_s + s * 2 * kBox;
      const float* dl = l2 + kBox;
      float sc[kBox / 2], dp[kBox / 2];  // S^T and dP^T: keys x queries
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wg::mma<0>(sc, desc_k(ka, kRows, w * 64, kk), desc_k(qs, kBox, 0, kk), kk > 0);
        wg::mma<0>(dp, desc_k(va, kRows, w * 64, kk), desc_k(dos, kBox, 0, kk), kk > 0);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();

      const bool edge = k0 + w * 64 + 63 >= kv_len || q0 + kBox > Tq ||
                        (causal && k0 + w * 64 + 63 > q0);
#pragma unroll
      for (int n = 0; n < kBox / 8; ++n) {
        const int col = 8 * n + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(l2 + col);
        const float2 dlv = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p = exp2f(fmaf(sc[i], c, -((e & 1) ? lv.y : lv.x)));
          if (edge) {
            const int key = k0 + wrow + 8 * ((e >> 1) & 1), q = q0 + col + (e & 1);
            if (key >= kv_len || q >= Tq || (causal && key > q)) p = 0.f;
          }
          sc[i] = p;                                        // P^T
          dp[i] = p * (dp[i] - ((e & 1) ? dlv.y : dlv.x));  // dS^T
        }
      }
      uint32_t ph[kBox / 16][4], pl[kBox / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) split_a(sc, kk, ph[kk], pl[kk]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {  // dV += P^T dO
        wg::mma<1>(adv, ph[kk], desc_n(dos, kBox, kk));
        wg::mma<1>(adv, pl[kk], desc_n(dos, kBox, kk));
      }
      wg::wgmma_commit();
      // at dh = 128 the accumulators alone take 128 registers: let the P
      // pair go before the dS pair is built
      if constexpr (DH == 128) wg::wgmma_wait<0>();
      uint32_t sh[kBox / 16][4], sl[kBox / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) split_a(dp, kk, sh[kk], sl[kk]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {  // dK += dS^T Q
        wg::mma<1>(adk, sh[kk], desc_n(qs, kBox, kk));
        wg::mma<1>(adk, sl[kk], desc_n(qs, kBox, kk));
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    store_rows<DH>(adk, scale, ks, kRows, w * 64, w, dk, b, Tk, H, h, k0);
    store_rows<DH>(adv, 1.f, vs, kRows, w * 64, w, dv, b, Tk, H, h, k0);
    if (tid == 0) mbar_arrive(done);
  }
}

// ------------------------------------------------------- K2's attention core
//
// jl_attention_core: the attention of K2 (ops/fused_attention.py's
// fused_attention_sublayer, which replaces the JAX package's
// ops/fused_attention.py::fused_attention_sublayer, _attn_sublayer_kernel and
// its head-group-split twin) between its q/k/v GEMM and its out-projection
// GEMM (csrc/ln_gemm.cu). q, k and v are read in place from the packed
// [B*T, 3D] q/k/v tensor through 4-D maps with a time stride of 3D; the
// head outputs are written as bf16 [B, T, D].
//
// K2's contract is the JAX kernel's, not K6's: scores in f32 times
// f32(1/sqrt(dh)); keys at or past kv_len get finfo(f32).min, so a row with
// kv_len = 0 averages V uniformly over all T keys; p = exp(s - m) / sum is
// normalised in f32, then rounded to bf16, then multiplied by V with f32
// accumulation; each head's output is rounded to bf16. Normalising before
// P.V needs the row's final max and sum, so each block walks its keys twice
// on K6's machinery (producer warpgroup, TMA ring, the same tile layouts):
// pass 1 forms S = Q K^T and keeps the online row max and sum; pass 2 forms
// S again and feeds the normalised bf16 P to P.V as the register-A operand.
// That is 1.5x a one-pass forward's tensor work, for the reference's
// rounding point kept exactly (K6 instead rounds unnormalised P; that
// deviation is K6's own).
//  * Zero-length rows: with kv_len >= 1, key tiles wholly past kv_len
//    contribute exactly 0 in f32 (exp(finfo.min - m) underflows) and are
//    skipped. A row with kv_len = 0 is its own case: all T keys are taken as
//    valid with equal scores (0), which gives the reference's uniform
//    weights 1/T. Key slots past T do not exist: TMA fills them with zeros,
//    and the last tile masks them in registers.
//  * Registers: pass 2 at dh = 128 holds S, O and P (~170 a thread), over
//    the 168 that a trap anywhere in the consumers' code would hold them to,
//    so, as in K8, the consumers wait untimed and the issuing thread waits
//    timed on a barrier they arrive at when done.
constexpr int kCoreKeys = 128;  // keys of a tile

template <int DH>
struct CoreSmem {
  static constexpr uint32_t kQ = tile_bytes<DH>(kRows);
  static constexpr uint32_t kKV = tile_bytes<DH>(kCoreKeys);  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr size_t kBytes = 1024 + kQ + kStages * kStage + (2 + 2 * kStages) * 8;
};

// S = Q K^T of a consumer warpgroup's 64 rows against the key tile at k0
// (K in shared memory at ks), with keys at or past n_keys set to NEG and,
// for a uniform row set (kv_len = 0), every other score set to 0
template <int DH>
__device__ __forceinline__ void core_scores(float (&sc)[kCoreKeys / 2], uint32_t qa, uint32_t ks,
                                            int w, int t, int k0, int n_keys, bool uniform) {
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wg::mma<0>(sc, desc_k(qa, kRows, w * 64, kk), desc_k(ks, kCoreKeys, 0, kk), kk > 0);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  if (uniform || k0 + kCoreKeys > n_keys) {
#pragma unroll
    for (int i = 0; i < kCoreKeys / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      sc[i] = key >= n_keys ? NEG : (uniform ? 0.f : sc[i]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_core_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const int* __restrict__ lens,
                      bf16* __restrict__ out, int H, int T, float scale) {
  using L = CoreSmem<DH>;
  constexpr int BN = kCoreKeys;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* st = qs + L::kQ;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(st + kStages * L::kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // the consumers' last arrival

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int kv_len = max(0, min(lens[b], T));
  const bool uniform = kv_len == 0;
  const int n_keys = uniform ? T : kv_len;
  const int n_tiles = ceil_div(n_keys, BN);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(done, 2);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(qbar, L::kQ);
      load_tile<DH>(qs, kRows, &tq, h, q0, b, qbar);
      // pass 1 streams the K tiles, pass 2 the K and V tiles, through one ring
      for (int j = 0; j < 2 * n_tiles; ++j) {
        const int s = j % kStages, k0 = (j % n_tiles) * BN;
        const bool pass2 = j >= n_tiles;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], pass2 ? L::kStage : L::kKV);
        load_tile<DH>(st + s * L::kStage, BN, &tk, h, k0, b, &full[s]);
        if (pass2) load_tile<DH>(st + s * L::kStage + L::kKV, BN, &tv, h, k0, b, &full[s]);
      }
      mbar_wait(done, 0);  // the consumers' waits are untimed: a stall traps here
    }
  } else {  // the two consumer warpgroups (warps 0-7)
    wg::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128, t = tid % 4;
    const float c = scale * kLog2e;
    const uint32_t qa = smem_u32(qs);
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // raw-score max, per-thread partial sums

    mbar_wait_untimed(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {  // pass 1: the row max and sum
      const int s = j % kStages;
      mbar_wait_untimed(&full[s], (j / kStages) & 1);
      float sc[BN / 2];
      core_scores<DH>(sc, qa, smem_u32(st + s * L::kStage), w, t, j * BN, n_keys, uniform);
      if (tid == 0) mbar_arrive(&empty[s]);
      float mt[2] = {m[0], m[1]}, mc[2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        l[r] *= exp2f((m[r] - mt[r]) * c);
        m[r] = mt[r];
        mc[r] = mt[r] * c;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) l[(i >> 1) & 1] += exp2f(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
    }
    float mc[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      mc[r] = m[r] * c;
      inv[r] = 1.f / l[r];  // l >= 1: the max term is exp(0)
    }

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {  // pass 2: P = bf16(exp(s - m) / sum), O += P V
      const int jj = n_tiles + j, s = jj % kStages;
      mbar_wait_untimed(&full[s], (jj / kStages) & 1);
      const uint32_t ks = smem_u32(st + s * L::kStage), vs = ks + L::kKV;
      float sc[BN / 2];
      core_scores<DH>(sc, qa, ks, w, t, j * BN, n_keys, uniform);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], c, -mc[(i >> 1) & 1])) * inv[(i >> 1) & 1];
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(sc, kk, pa[kk]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wg::mma<1>(o, pa[kk], desc_n(vs, BN, kk));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    store_rows<DH>(o, 1.f, qs, kRows, w * 64, w, out, b, T, H, h, q0);
    if (tid == 0) mbar_arrive(done);
  }
}

// ------------------------------------------------------------------ host

// [B, T, H, dh] bf16 with batch / time strides in elements (multiples of 8)
// -> a 4-D map (dh, H, T, B) with 64 x 1 x 64 x 1 boxes, 128-byte swizzle
bool head_map(CUtensorMap* map, const bf16* p, long long sb, long long st, int B, int T, int H,
              int dh) {
  return make_tmap<4>(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B},
                      {(cuuint64_t)dh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2},
                      {64u, 1u, (cuuint32_t)kBox, 1u}, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int DH>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const int* lens, bf16* out, float* lse, int B, int H, int Tq, int Tk, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = FwdSmem<DH>::kBytes;
  int err = set_smem(flash_fwd_kernel<DH>, smem);
  if (err) return err;
  flash_fwd_kernel<DH><<<dim3(ceil_div(Tq, kRows), B * H), kBlockThreads, smem, stream>>>(
      tq, tk, tv, lens, out, lse, H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tdo, const bf16* o, const bf16* dout, const float* lse,
               const int* lens, bf16* dq, bf16* dk, bf16* dv, float* stats, int B, int H, int Tq,
               int Tk, int causal, float scale, cudaStream_t stream) {
  const int Tp = ceil_div(Tq, kRows) * kRows;
  int err = set_smem(flash_bwd_dq_kernel<DH>, DqSmem<DH>::kBytes);
  if (err) return err;
  err = set_smem(flash_bwd_dkv_kernel<DH>, DkvSmem<DH>::kBytes);
  if (err) return err;
  const size_t dq_smem = DqSmem<DH>::kBytes, dkv_smem = DkvSmem<DH>::kBytes;
  flash_bwd_dq_kernel<DH><<<dim3(ceil_div(Tq, kRows), B * H), kBlockThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, o, dout, lse, lens, dq, stats, H, Tq, Tk, Tp, causal, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dkv_kernel<DH><<<dim3(ceil_div(Tk, kRows), B * H), kBlockThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, stats, lens, dk, dv, H, Tq, Tk, Tp, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_core(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const int* lens, bf16* out, int B, int H, int T, float scale,
                cudaStream_t stream) {
  const size_t smem = CoreSmem<DH>::kBytes;
  int err = set_smem(attention_core_kernel<DH>, smem);
  if (err) return err;
  attention_core_kernel<DH><<<dim3(ceil_div(T, kRows), B * H), kBlockThreads, smem, stream>>>(
      tq, tk, tv, lens, out, H, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v: base pointer, batch stride, time stride (elements; multiples of 8
// below 2^39, pointers 16-byte aligned); out [B, Tq, H, dh] and lse
// [B*H, Tq] are contiguous. Tq, Tk >= 1.
extern "C" int jl_flash_fwd(const bf16* q, long long q_sb, long long q_st, const bf16* k,
                            long long k_sb, long long k_st, const bf16* v, long long v_sb,
                            long long v_st, const int* lens, bf16* out, float* lse, int B,
                            int H, int Tq, int Tk, int dh, int causal, float scale,
                            cudaStream_t stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, q_sb, q_st, B, Tq, H, dh) ||
      !head_map(&tk, k, k_sb, k_st, B, Tk, H, dh) || !head_map(&tv, v, v_sb, v_st, B, Tk, H, dh))
    return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch_fwd<64>(tq, tk, tv, lens, out, lse, B, H, Tq, Tk, causal, scale, stream);
  return launch_fwd<128>(tq, tk, tv, lens, out, lse, B, H, Tq, Tk, causal, scale, stream);
}

// out and dout are contiguous [B, Tq, H, dh]; dq / dk / dv contiguous like
// q / k; stats: f32 scratch [B*H, 2, Tp], Tp = Tq rounded up to 128
extern "C" int jl_flash_bwd(const bf16* q, long long q_sb, long long q_st, const bf16* k,
                            long long k_sb, long long k_st, const bf16* v, long long v_sb,
                            long long v_st, const bf16* o, const bf16* dout,
                            const float* lse, const int* lens, bf16* dq, bf16* dk, bf16* dv,
                            float* stats, int B, int H, int Tq, int Tk, int dh, int causal,
                            float scale, cudaStream_t stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  const long long row = (long long)H * dh;
  if (!head_map(&tq, q, q_sb, q_st, B, Tq, H, dh) ||
      !head_map(&tk, k, k_sb, k_st, B, Tk, H, dh) || !head_map(&tv, v, v_sb, v_st, B, Tk, H, dh) ||
      !head_map(&tdo, dout, row * Tq, row, B, Tq, H, dh))
    return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch_bwd<64>(tq, tk, tv, tdo, o, dout, lse, lens, dq, dk, dv, stats, B, H, Tq, Tk,
                          causal, scale, stream);
  return launch_bwd<128>(tq, tk, tv, tdo, o, dout, lse, lens, dq, dk, dv, stats, B, H, Tq, Tk,
                         causal, scale, stream);
}

// K2's core: qkv [B*T, 3D] bf16 (q | k | v, D = H dh, D % 8 == 0, 16-byte
// aligned), lens [B] i32 -> out [B, T, D] bf16, the heads' outputs rounded
// to bf16; scale = f32(1 / sqrt(dh)). T >= 1.
extern "C" int jl_attention_core(const bf16* qkv, const int* lens, bf16* out, int B, int T,
                                 int H, int dh, float scale, cudaStream_t stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  const long long D = (long long)H * dh, st = 3 * D, sb = (long long)T * st;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, qkv, sb, st, B, T, H, dh) || !head_map(&tk, qkv + D, sb, st, B, T, H, dh) ||
      !head_map(&tv, qkv + 2 * D, sb, st, B, T, H, dh))
    return (int)cudaErrorInvalidValue;
  if (dh == 64) return launch_core<64>(tq, tk, tv, lens, out, B, H, T, scale, stream);
  return launch_core<128>(tq, tk, tv, lens, out, B, H, T, scale, stream);
}
