// K1: fused log-mel spectrogram with the DFT on the tensor cores in 3xTF32;
// and P1, the same kernel with the DFT as three bf16 products.
//
// Replaces frontend/pallas_frontend.py::fused_log_mel_raw (_logmel_kernel)
// of the JAX package: reflect-pad by n_fft/2, hop-framed periodic-Hann DFT
// as a matrix product at HIGHEST precision, power, mel product,
// log10(max(., floor)); only the [B, num_mels, T] log-mel leaves the kernel.
// The JAX kernel reads the padded wave as hop-width rows [B, n_chunks, hop]:
// frame t is rows t, t+1, t+2 (the third cut to n_fft - 2 hop), and the DFT
// is sum_j rows_j . basis[j hop, (j+1) hop).
//
// What bounds it on the H100: the DFT must stay f32-accurate (a bf16 or
// single TF32 product leaves ~0.1-0.3 absolute error at deep spectral
// valleys against the 2e-4 bar), which on the CUDA cores is 2 x 400 x 402
// f32 FMAs a frame (30.9 GFLOP at 32 x 30 s: 0.46 ms at 67 TFLOP/s).
// 3xTF32 moves it to the tensor cores: each f32 operand a is split into
// hi = tf32(a) and lo = tf32(a - hi), and hi.hi' + hi.lo' + lo.hi' is
// accumulated in f32 (the dropped lo.lo' is ~2^-22 relative): three TF32
// products, 92.6 GFLOP, 0.187 ms at 495 TFLOP/s. The signal is 1.9 MB a
// 30 s utterance; the basis (hi and lo, 1.4 MB) is read from L2 by every
// block.
//
// Design: one block per (128 frames, utterance), a producer warpgroup and
// two consumer warpgroups of 64 frames each (setmaxnreg 40 / 232).
//  * The signal: the block stages its rows of the reflect-padded wave,
//    [128 + 2][hop] f32 at a pitch of hop + 4 floats, in shared memory.
//    Frame f, DFT column k is row f + k / hop, column k % hop, so frames
//    are never copied, and with hop % 16 == 0 a 16-wide k step never
//    crosses a row. wgmma .tf32 takes A K-major; here A comes from
//    registers: each thread reads its fragment (rows g, g + 8, columns t,
//    t + 4) from the staged rows (the pitch makes the 32 lanes hit 32
//    banks) and splits it into hi and lo with cvt.rna.tf32.f32.
//  * The basis: [416 columns][416 k] f32, pre-split into hi and lo on the
//    host (fused_frontend.tf32_basis), zero past n_fft and n_freqs; K-major
//    as wgmma .tf32 needs B. Its columns interleave cos and sin in groups
//    of 8 (16 q + e: cos of frequency 8 q + e; 16 q + 8 + e: sin), so the
//    accumulator of one thread holds the real and imaginary part of the
//    same frequency and the power is formed in registers. Two passes of
//    208 columns (104 frequencies, 104 running sums a thread): the
//    producer thread streams [208][16] hi and lo boxes (64-byte swizzle)
//    through three stages, 25 k steps a pass at n_fft 400.
//  * Accumulation: each k step of each 104-column half runs its six
//    products (m64n104k8) into a fresh register tile, which is then added
//    to the running sums with round-to-nearest f32 adds (104 a k step).
//    Left to the tensor cores' own f32 accumulation over all 1,200 terms,
//    the error reached the 2e-4 bar at 128 mels on the H100; with the
//    adds it is at or below the plain f32 version's own error (chip_smoke
//    prints both against an f64 log-mel). The first pass's power goes to
//    its own shared tile: held in registers across the second pass, it
//    spilled.
//  * Power, mel, log: the consumers store the second pass's power over
//    the freed signal and stage memory, then each thread takes one frame
//    and every other mel: the sum runs over the filter's nonzero
//    columns only (bands, from the host: adding the exact zeros outside
//    them changes no bit of an f32 sum), then log10(max(., floor)),
//    stored coalesced along the frames.
//  * As in K8, the consumers wait untimed (a trap would hold them to the
//    168-register entry count) and the issuing thread waits timed on a
//    barrier they arrive at when the DFT is done.
//
// P1 (kBF16x3), the A/B probe of examples/profile_frontend_precision.py
// (_kernel_split under its pallas_call; its partner is K1): the same
// kernel templated on the operand split. The frames are split with
// cvt.rn.bf16.f32 into hi and lo = bf16(a - hi), the basis is K1's
// interleaved layout split the same way on the host (fused_frontend.
// bf16_split), and each k step is one bf16 wgmma m64n104k16 a product
// (A from registers), against two k8 ones in TF32: lo.hi + hi.lo + hi.hi
// into the fresh tile, as the plain version's hi.hi + lo.hi + hi.lo of
// exact bf16 products. The basis boxes are [208][16] bf16 with the 32-byte
// swizzle. Its epilogue is the probe's log(max(., floor)) * f32(1 / ln 10).
// Bound on the H100: the three bf16 products, 92.6 G at 32 x 30 s, 0.094 ms
// at 989 TFLOP/s; bf16 runs at twice the TF32 rate, and each bf16 operand
// drops 2 of TF32's 10 mantissa bits more (the probe's record: about 1000x
// over the 2e-4 bar at deep spectral valleys).
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace jl;

constexpr int kFrames = 128;      // frames a block: 64 for each consumer warpgroup
constexpr int kPassN = 208;       // basis columns a pass: two halves of m64n104k8
constexpr int kPasses = 2;        // 2 x 208 columns: 208 frequencies, cos and sin
constexpr int kMaxFreqs = kPasses * kPassN / 2;
constexpr int kPassF = kPassN / 2;  // frequencies a pass
constexpr int kKStep = 16;        // k of a stage: one swizzled row (64 bytes f32, 32 bf16)
constexpr int kKPad = 416;        // the basis's k extent: n_fft <= 416
constexpr int kLdp = kPassF + 1;  // f32 row pitch of the two power tiles
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kInvLn10 = 0.4342944819032518f;  // np.float32(1 / np.log(10))

// the operand split: K1's 3xTF32, P1's bf16x3
enum Split { kTF32x3, kBF16x3 };
template <int S>
struct SplitOf;
template <>
struct SplitOf<kTF32x3> {
  static constexpr int kElem = 4;  // bytes of a basis element
  static constexpr int kSub = 2;   // products of a 16-wide k step: k8
  static constexpr uint64_t kLayout = 2;  // wgmma's 64-byte swizzle
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct SplitOf<kBF16x3> {
  static constexpr int kElem = 2;
  static constexpr int kSub = 1;   // one k16
  static constexpr uint64_t kLayout = 3;  // wgmma's 32-byte swizzle
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
// one [208][16] basis box, its second 104 columns, a stage (its hi and lo)
template <int S>
constexpr uint32_t kBoxBytes = kPassN * kKStep * SplitOf<S>::kElem;
template <int S>
constexpr uint32_t kHalfBytes = kBoxBytes<S> / 2;
template <int S>
constexpr uint32_t kStageBytes = 2 * kBoxBytes<S>;
// one pass's power, [128][kLdp] f32, rounded up to keep the stages 1024-aligned
constexpr uint32_t kPowerBytes = (kFrames * kLdp * 4 + 1023) & ~1023u;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr uint32_t seg_bytes(int rows, int hop) {
  return ((uint32_t)rows * (hop + 4) * 4 + 1023) & ~1023u;
}
__host__ __device__ inline int seg_rows(int n_fft, int hop) {
  return kFrames + (ceil_div(n_fft, kKStep) * kKStep - 1) / hop;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// d[52] (+)= A (64 x 8 tf32 in registers: a[0] (row g, col t), a[1] (g + 8,
// t), a[2] (g, t + 4), a[3] (g + 8, t + 4) of each warp's 16 rows, g =
// lane / 4, t = lane % 4) . B (8 x 104 tf32, shared, K-major); scale_d == 0
// overwrites d instead of adding to it
__device__ __forceinline__ void mma_tf32_n104(float (&d)[52], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %57, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51 "
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n\t}"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// K-major B at row 0 of a [rows][16] box: f32 with the 64-byte swizzle
// (8-row groups 512 bytes apart; kk the k8 step), or bf16 with the 32-byte
// swizzle (8-row groups 256 bytes apart; one k16 step)
template <int S>
__device__ __forceinline__ uint64_t basis_desc(uint32_t box, int kk) {
  constexpr uint32_t group = 8 * kKStep * SplitOf<S>::kElem;
  const uint32_t addr = box + kk * 32;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(group >> 4) << 32) | (SplitOf<S>::kLayout << 62);
}

// the A fragments of k columns [c0, c0 + 16) of staged rows `row` and
// row + 8, split into hi and lo: TF32 (two k8 fragments: a[0] (row, t),
// a[1] (row + 8, t), a[2] (row, t + 4), a[3] (row + 8, t + 4), then the
// same 8 columns on) or bf16 (one k16 fragment of column pairs: a[0] (row,
// 2t, 2t + 1), a[1] (row + 8, ..), a[2] (row, 2t + 8, 2t + 9), a[3] (row +
// 8, ..)), t = lane % 4
template <int S>
__device__ __forceinline__ void load_a(const float* seg, int pitch, int row, int c0, int t,
                                       uint32_t (&hi)[SplitOf<S>::kSub][4],
                                       uint32_t (&lo)[SplitOf<S>::kSub][4]) {
  if constexpr (S == kTF32x3) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = seg[(row + 8 * (e & 1)) * pitch + c0 + 8 * kk + t + 4 * (e >> 1)];
        hi[kk][e] = tf32_rna(v);
        lo[kk][e] = tf32_rna(v - __uint_as_float(hi[kk][e]));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = *reinterpret_cast<const float2*>(
          seg + (row + 8 * (e & 1)) * pitch + c0 + 2 * t + 8 * (e >> 1));
      const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // cvt.rn.bf16x2.f32
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
      hi[0][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[0][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// d[52] (+)= A (64 x 8 tf32, or 64 x 16 bf16, registers) . B (shared,
// K-major); scale_d == 0 overwrites d
template <int S>
__device__ __forceinline__ void mma_n104(float (&d)[52], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  if constexpr (S == kTF32x3) mma_tf32_n104(d, a, desc_b, scale_d);
  else wg::mma_m64n104k16_rs<0>(d, a, desc_b, scale_d);
}

// The consumers: the DFT of the block's frames in two passes of 208 basis
// columns, each pass's power into its tile (pw0; the second over the freed
// rows and stages), then mel and log (K1: log10; P1: log * f32(1 / ln 10)).
template <int S>
__device__ __forceinline__ void consume(float* seg, float* pw0, int pitch, uint8_t* st,
                                        uint64_t* full, uint64_t* empty, uint64_t* done,
                                        int ksteps, int hop,
                                        const float* __restrict__ mel,
                                        const int* __restrict__ bands, float* __restrict__ out,
                                        int b, int t0, int T, int n_freqs, int num_mels,
                                        float log_floor) {
  const int w = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int f0 = w * 64 + (tid / 32) * 16 + g;  // this thread's frames f0 and f0 + 8
  float* pw1 = seg;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    float acc[kPassN / 2];
#pragma unroll
    for (int i = 0; i < kPassN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int i = pass * ksteps + ks, s = i % kStages;
      // k columns [16 ks, 16 ks + 16) of frame f: row f + j, columns from c0
      const int j = ks * kKStep / hop, c0 = ks * kKStep - j * hop;
      uint32_t ahi[SplitOf<S>::kSub][4], alo[SplitOf<S>::kSub][4];
      load_a<S>(seg, pitch, f0 + j, c0, t, ahi, alo);
      mbar_wait_untimed(&full[s], (i / kStages) & 1);
      // each half's k step into a fresh tile, then into the running sums
      // with round-to-nearest adds
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t bh = smem_u32(st + s * kStageBytes<S>) + half * kHalfBytes<S>;
        const uint32_t bl = bh + kBoxBytes<S>;
        float part[kPassN / 4];
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SplitOf<S>::kSub; ++kk) {
          mma_n104<S>(part, alo[kk], basis_desc<S>(bh, kk), kk);
          mma_n104<S>(part, ahi[kk], basis_desc<S>(bl, kk), 1);
          mma_n104<S>(part, ahi[kk], basis_desc<S>(bh, kk), 1);
        }
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < kPassN / 4; ++e) acc[half * (kPassN / 4) + e] += part[e];
      }
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    if (pass == kPasses - 1) {
      if (tid == 0) mbar_arrive(done);
      // every product of both warpgroups is complete: the staged rows and
      // the stages are free for the second power tile
      wg::consumer_sync();
      fence_proxy_async();
    }
    // n8 blocks 2q and 2q + 1 of the pass: cos and sin of frequencies
    // 104 pass + 8 q + 2 t + (e & 1), frames f0 + 8 (e >> 1)
    float* pw = pass == 0 ? pw0 : pw1;
#pragma unroll
    for (int q = 0; q < kPassN / 16; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc[8 * q + e], im = acc[8 * q + 4 + e];
        pw[(f0 + 8 * (e >> 1)) * kLdp + 8 * q + 2 * t + (e & 1)] =
            __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
  }
  wg::consumer_sync();

  // mel product over each filter's band, then the log: thread -> one frame,
  // every other mel (a warp: 32 frames of one mel, the weights broadcast)
  const int fr = threadIdx.x % kFrames, tt = t0 + fr;
  for (int m = threadIdx.x / kFrames; m < num_mels; m += kConsumers / kFrames) {
    const int k1 = bands[2 * m + 1];
    const float* mrow = mel + (size_t)m * n_freqs;
    float a = 0.f;
    for (int k = bands[2 * m]; k < k1; ++k) {
      const float p = k < kPassF ? pw0[fr * kLdp + k] : pw1[fr * kLdp + k - kPassF];
      a = fmaf(p, __ldg(mrow + k), a);
    }
    if (tt < T)
      out[((size_t)b * num_mels + m) * T + tt] =
          S == kTF32x3 ? log10f(fmaxf(a, log_floor))
                       : __fmul_rn(logf(fmaxf(a, log_floor)), kInvLn10);
  }
}

// wav [B, L] f32; thi / tlo: maps of the basis hi / lo [416][416] (f32
// for K1, bf16 for P1); mel [num_mels][n_freqs] f32; bands [num_mels][2]
// i32, the first and one-past-last nonzero column of each filter; out
// [B][num_mels][T] f32
template <int S>
__global__ void __launch_bounds__(kBlockThreads, 1)
log_mel_tf32_kernel(const __grid_constant__ CUtensorMap thi,
                    const __grid_constant__ CUtensorMap tlo,
                    const float* __restrict__ wav, const float* __restrict__ mel,
                    const int* __restrict__ bands, float* __restrict__ out, int L, int T,
                    int n_fft, int hop, int n_freqs, int num_mels, float log_floor) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int pitch = hop + 4, rows = seg_rows(n_fft, hop);
  const int ksteps = ceil_div(n_fft, kKStep);
  float* seg = reinterpret_cast<float*>(base);
  float* pw0 = reinterpret_cast<float*>(base + seg_bytes(rows, hop));
  uint8_t* st = base + seg_bytes(rows, hop) + kPowerBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(st + kStages * kStageBytes<S>);
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // the consumers' arrivals after the DFT

  const int b = blockIdx.y, t0 = blockIdx.x * kFrames;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(done, 2);
    fence_barrier_init();
  }
  // the block's rows of the reflect-padded wave: row r, column c is padded
  // sample (t0 + r) hop + c, i.e. wave sample (t0 + r) hop + c - n_fft / 2
  // reflected at both ends; 0 past the padded wave (only past frame T)
  const float* x = wav + (size_t)b * L;
  for (int i = threadIdx.x; i < rows * hop; i += kBlockThreads) {
    const int r = i / hop, c = i - r * hop;
    int j = (t0 + r) * hop + c - n_fft / 2;
    if (j < 0) j = -j;
    if (j >= L) j = 2 * (L - 1) - j;
    seg[r * pitch + c] = (j >= 0 && j < L) ? x[j] : 0.f;
  }
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it uniform: the
  // setmaxnreg regions below are then the roles' whole branches
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer warpgroup
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < kPasses * ksteps; ++i) {
        const int s = i % kStages, pass = i / ksteps, ks = i % ksteps;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes<S>);
        uint8_t* dst = st + s * kStageBytes<S>;
        tma_load_2d(dst, &thi, ks * kKStep, pass * kPassN, &full[s]);
        tma_load_2d(dst + kBoxBytes<S>, &tlo, ks * kKStep, pass * kPassN, &full[s]);
      }
      mbar_wait(done, 0);  // the consumers' waits are untimed: a stall traps here
    }
  } else {  // the two consumer warpgroups (warps 0-7)
    wg::reg_alloc<kConsumerRegs>();
    consume<S>(seg, pw0, pitch, st, full, empty, done, ksteps, hop, mel, bands, out, b, t0, T,
            n_freqs, num_mels, log_floor);
  }
}

// wav [B, L] f32 -> out [B, num_mels, T] f32 (T = L / hop frames) with
// basis_hi / basis_lo [416][416] (f32 for K1, bf16 for P1), mel
// [num_mels][n_freqs] f32, bands [num_mels][2] i32. hop % 16 == 0,
// n_fft <= 416, n_freqs <= 208, L > n_fft / 2; the staged rows, the first
// power tile and the stages within one block's shared memory (hop <= 160
// at n_fft 400).
template <int S>
int log_mel(const float* wav, const void* basis_hi, const void* basis_lo, const float* mel,
            const int* bands, float* out, int B, int L, int T, int n_fft, int hop, int n_freqs,
            int num_mels, float log_floor, cudaStream_t stream) {
  if (hop <= 0 || hop % kKStep || n_fft > kKPad || n_freqs > kMaxFreqs || T < 1 ||
      L <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      1024 + seg_bytes(seg_rows(n_fft, hop), hop) + kPowerBytes + kStages * kStageBytes<S> +
      (2 * kStages + 1) * 8;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap thi, tlo;
  const uint64_t pitch = (uint64_t)kKPad * SplitOf<S>::kElem;
  if (!make_tmap_2d(&thi, basis_hi, SplitOf<S>::kType, kKPad, 2 * kMaxFreqs, pitch, kKStep,
                    kPassN, SplitOf<S>::kSwizzle) ||
      !make_tmap_2d(&tlo, basis_lo, SplitOf<S>::kType, kKPad, 2 * kMaxFreqs, pitch, kKStep,
                    kPassN, SplitOf<S>::kSwizzle))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(log_mel_tf32_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_tf32_kernel<S><<<dim3(ceil_div(T, kFrames), B), kBlockThreads, smem, stream>>>(
      thi, tlo, wav, mel, bands, out, L, T, n_fft, hop, n_freqs, num_mels, log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: log10-mel; basis_hi / basis_lo [416][416] f32 (fused_frontend.
// tf32_basis split by tf32_split). Arguments and limits as log_mel above.
extern "C" int jl_log_mel(const float* wav, const float* basis_hi, const float* basis_lo,
                          const float* mel, const int* bands, float* out, int B, int L, int T,
                          int n_fft, int hop, int n_freqs, int num_mels, float log_floor,
                          cudaStream_t stream) {
  return log_mel<kTF32x3>(wav, basis_hi, basis_lo, mel, bands, out, B, L, T, n_fft, hop,
                          n_freqs, num_mels, log_floor, stream);
}

// P1: log(mel) * f32(1 / ln 10) with the DFT in bf16x3; basis_hi /
// basis_lo [416][416] bf16 (fused_frontend.tf32_basis split by
// bf16_split). Arguments and limits as log_mel above.
extern "C" int jl_log_mel_bf16x3(const float* wav, const bf16* basis_hi, const bf16* basis_lo,
                                 const float* mel, const int* bands, float* out, int B, int L,
                                 int T, int n_fft, int hop, int n_freqs, int num_mels,
                                 float log_floor, cudaStream_t stream) {
  return log_mel<kBF16x3>(wav, basis_hi, basis_lo, mel, bands, out, B, L, T, n_fft, hop,
                          n_freqs, num_mels, log_floor, stream);
}
