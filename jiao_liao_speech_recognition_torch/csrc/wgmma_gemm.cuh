// The mainloop of a TMA-fed wgmma GEMM for Hopper (sm_90a), written to be
// shared: C[128 x 128 tile] = A . B in f32 for bf16 A [M, K] row-major
// (K-major) and bf16 B [K, N] row-major (N-major, as the JAX Dense kernels
// are stored: [in, out]). The caller owns the epilogue. Beside it, the
// products other kernels build their own loops on: bf16 with A from
// registers at N 64, 104 and 128, and s8 x s8 -> s32 (csrc/w8a8_mlp.cu).
//
// (csrc/ln_gemm.cu's persistent GEMM takes the tile constants and products
// below with its own loop.) A block of wg::Pipeline runs one output tile
// (or, with a running k-block base, several in turn: csrc/head.cu's P2)
// with three roles:
//  * a producer warp (warp 8) that keeps STAGES k-blocks of 64 in flight:
//    per stage one TMA box of A (128 rows x 64, 16 KB) and two of B (64 x 64
//    each, 16 KB), all with the 128-byte swizzle, counted on the stage's
//    "full" mbarrier;
//  * two consumer warpgroups (warps 0-3 and 4-7), each issuing wgmma
//    m64n128k16 (bf16 in, f32 accumulators in registers: 64 a thread) on
//    its 64 rows of the stage, then releasing the stage on its "empty"
//    mbarrier once the products that read it have completed.
// B needs no transposed copy: wgmma reads an N-major B through its
// descriptor (imm-trans-b = 1), whose 64-column blocks lie 8 KB apart (the
// leading byte offset) and whose 8-row k groups lie 1 KB apart (the stride
// byte offset). A is K-major: 8-row groups 1 KB apart, a k16 step 32 bytes
// further into the 128-byte swizzled row.
#pragma once

#include "tma.cuh"

namespace jl {
namespace wg {

constexpr int kBM = 128;  // tile rows: two warpgroups of 64
constexpr int kBN = 128;  // tile columns: one m64n128 product a warpgroup
constexpr int kBK = 64;   // k per stage: one 128-byte swizzled row of bf16
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kBSlabBytes = kBK * 64 * 2;  // 64 k rows x 64 columns
constexpr uint32_t kStageBytes = kABytes + 2 * kBSlabBytes;
constexpr int kConsumerBarrier = 1;  // named barrier of the 256 consumer threads

// dynamic shared memory of a block with `stages` stages: the stages, 1 KB to
// align them for the swizzle, and the 2 x stages barriers
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return (size_t)stages * kStageBytes + 1024 + 2 * stages * sizeof(uint64_t);
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kConsumerBarrier), "n"(kConsumerThreads) : "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// an arrival at named barrier `id` that does not wait for it
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// tells the compiler that the registers of `r` may change here (a wgmma
// that wrote them has just been waited for), so no access to them moves
// across this point
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// warp-specialised register budgets: the producer warp gives registers up,
// the consumer warpgroups take them (each warpgroup as a whole, once, at
// the top of its own branch)
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// The products, one wgmma each (bf16 in, f32 accumulators in registers).
// Shared operands come through 128-byte-swizzled descriptors (desc_sw128);
// a register A is the m16n8k16 A fragment of each warp's 16 rows, which is,
// element for element, the accumulator layout of an earlier product (the
// flash kernels feed P and dS back this way). Overloads on the accumulator
// size pick N: float[32] is N = 64, float[64] N = 128; int[64] is the s8
// product at N = 128.

// d[32] (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared; N-major when
// TRANS_B == 1); scale_d == 0 overwrites d instead of adding to it
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// d[64] (+)= A (64 x 16, shared, K-major) . B (16 x 128, shared; N-major when
// TRANS_B == 1); scale_d == 0 overwrites d instead of adding to it
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// d[32] += A (64 x 16, registers: the m16n8k16 A fragment of each warp's 16
// rows, 4 x b32 of bf16 pairs) . B (16 x 64, shared; N-major when TRANS_B == 1)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d[64] += A (64 x 16, registers: the m16n8k16 A fragment of each warp's 16
// rows, 4 x b32 of bf16 pairs) . B (16 x 128, shared; N-major when TRANS_B == 1)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d[52] (+)= A (64 x 16, registers: the m16n8k16 A fragment of each warp's 16
// rows, 4 x b32 of bf16 pairs) . B (16 x 104, shared; N-major when TRANS_B ==
// 1); scale_d == 0 overwrites d instead of adding to it
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n104k16_rs(float (&d)[52], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %57, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, %58;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The 8-bit products (s8 x s8 -> s32, exact): wgmma takes both 8-bit
// operands K-major only ([rows][k] and [n][k] in shared memory, no
// transpose immediate); the accumulator layout is the f32 one (acc_row,
// acc_col below), a k32 step reads 32 bytes of each row, as a bf16 k16
// step does.

// d[64] (+)= A (64 x 32 s8, shared, K-major) . B (32 x 128 s8, shared,
// K-major: [n][k]); scale_d == 0 overwrites d instead of adding to it
__device__ __forceinline__ void mma_s8_m64n128k32(int (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d = 1) {
  mma_m64n64k16<TRANS_B>(d, desc_a, desc_b, scale_d);
}
template <int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d = 1) {
  mma_m64n128k16<TRANS_B>(d, desc_a, desc_b, scale_d);
}
template <int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  mma_m64n64k16_rs<TRANS_B>(d, a, desc_b);
}
template <int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  mma_m64n128k16_rs<TRANS_B>(d, a, desc_b);
}
__device__ __forceinline__ void mma(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d = 1) {
  mma_s8_m64n128k32(d, desc_a, desc_b, scale_d);
}

// accumulator i of a consumer thread (tid in 0..127 of its warpgroup): its
// row in the warpgroup's 64 and its column in the tile's 128 (the m16n8
// fragment layout, repeated over 16 n8 column blocks)
__device__ __forceinline__ int acc_row(int tid, int i) {
  return (tid / 32) * 16 + (tid % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid % 4) + (i & 1);
}

// The block's shared memory: STAGES stages (1024-aligned for the swizzle),
// then the full and empty barriers.
template <int STAGES>
struct Pipeline {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Pipeline(uint8_t* smem_raw) {
    const uint32_t raw = smem_u32(smem_raw);
    stages = smem_raw + (((raw + 1023) & ~1023u) - raw);
    full = reinterpret_cast<uint64_t*>(stages + (size_t)STAGES * kStageBytes);
    empty = full + STAGES;
  }

  // one thread, before the block's first __syncthreads
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }

  __device__ __forceinline__ uint8_t* a(int s) const {
    return stages + (size_t)s * kStageBytes;
  }
  __device__ __forceinline__ uint8_t* b(int s) const { return a(s) + kABytes; }

  // producer, one thread: k-blocks 0 .. kblocks-1 of the tile at (m0, n0);
  // ta maps A with 64 x 128 boxes, tb maps B with 64 x 64 boxes. `base` is
  // the number of k-blocks this block's pipeline has run before this tile
  // (0 for a block's first tile), so the stages and their barrier phases run
  // on across the tiles of a block that walks several.
  __device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* tb,
                                          int m0, int n0, int kblocks, int base = 0) const {
    for (int kb = 0; kb < kblocks; ++kb) {
      const int g = base + kb, s = g % STAGES;
      if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) - 1) & 1);
      mbar_arrive_expect_tx(&full[s], kStageBytes);
      tma_load_2d(a(s), ta, kb * kBK, m0, &full[s]);
      tma_load_2d(b(s), tb, n0, kb * kBK, &full[s]);
      tma_load_2d(b(s) + kBSlabBytes, tb, n0 + 64, kb * kBK, &full[s]);
    }
  }

  // consumer warpgroup `wgi` (0 or 1): acc = its 64 rows of A . B over all
  // k-blocks of a tile (`base` as in produce). Returns with every product
  // complete and every stage of the tile but its last released to the
  // producer; a block that walks on to another tile releases that one too
  // (release_last).
  __device__ __forceinline__ void consume(float (&acc)[64], int wgi, int kblocks,
                                          int base = 0) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const bool signals = threadIdx.x % 128 == 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int g = base + kb, s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
      const uint32_t a0 = smem_u32(a(s)) + wgi * 64 * 128;
      const uint32_t b0 = smem_u32(b(s));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        mma_m64n128k16<1>(acc, desc_sw128(a0 + 32 * j, 16, 1024),
                          desc_sw128(b0 + 2048 * j, kBSlabBytes, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done with it
      if (kb > 0 && signals) mbar_arrive(&empty[(g - 1) % STAGES]);
    }
    wgmma_wait<0>();
  }

  // consumer warpgroup, after consume: hands the tile's last stage back
  __device__ __forceinline__ void release_last(int kblocks, int base) const {
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(base + kblocks - 1) % STAGES]);
  }
};

}  // namespace wg
}  // namespace jl
