// K9: decode-step attention over head-major KV caches, bf16 or int8.
//
// Replaces ops/decode_attention.py::grouped_decode_attention of the JAX
// package (_grouped_kernel / _attend_head), both halves: bf16 caches, and
// the int8 caches of ops/quant.py::int8_decode_attention with f32
// per-position scales ks, vs [B, H, Tk] (and P3, the one-program-per-(b,
// head) int8 probe of examples/profile_int8_attn_kernel.py).
//
// Function, per (b, h): Tq <= 8 query rows q (bf16) against keys [0, Tk) of
// k, v [B, H, Tk, dh]: s = (q . k) * 1/sqrt(dh) in f32 (int8: * (ks[t] *
// 1/sqrt(dh)), the factor formed first); keys at or past min(kv_lens[b],
// Tk) get finfo(f32).min, so a zero-length row is uniform and finite;
// p = exp(s - max) / sum (int8: p * vs[t]), rounded to bf16; out = p . V
// accumulated in f32, written f32 [B, H, Tq, dh].
//
// What bounds it on the H100: device-memory bytes. A decode step reads the
// caches' valid prefixes once (B=16, 20 heads of 64: 123 MB of bf16 cross
// K/V at 1500 keys, a 36.7 us bound at 3.35 TB/s; int8 half the bytes plus
// 8 B of scales a key) for ~2 flops a byte, and the bytes must be in
// flight: ~2 us of memory latency under load times 3.35 TB/s is ~50 KB an
// SM.
//
// Design: one block of 8 warps per (b, h), all B*H blocks resident at once
// at the decode shapes (scores and scratch take 4-15 KB of shared memory).
// K is read once (pass 1), V once (pass 2), each key row of dh elements by
// dh/8 lanes with one 16-byte (bf16) or 8-byte (int8) load per lane,
// consecutive lanes on consecutive bytes, kRows rows in flight per lane
// (four of bf16, eight of int8 at Tq <= 2: the same bytes in flight, 16 KB
// a block). Pass 1 writes the scores into shared memory ([TQ][Tk] f32), and
// for int8 vs beside them (read with ks); the block then forms the row
// max, the row sum and the bf16 probabilities there, which is the
// reference's rounding point (p normalised, then cast, before P.V). Pass
// 2's first rows are requested before those reductions and each step's
// next rows before its sums, so V streams while the block reduces. Pass 2
// accumulates p * v per lane in f32 and reduces over lanes, then warps.
// Keys past a row's length have p = 0 exactly, so only the valid prefix is
// read (all Tk keys when the length is 0: the uniform average). int8 ->
// f32 by common.cuh::int8x4_to_f32 (a byte permute and an FADD, exact): no
// I2F, which issues at 16 a clock an SM, ~17 us of the whole card's issue
// for the cross caches' 61 MB.
//
// Not kept (PERF.md, section 6): the whole valid prefix copied into shared
// memory by bulk copies at block start, cross caches split over a cluster
// of 2-8 blocks combining (max, sum) and P.V partials in rank order through
// distributed shared memory, in three forms (a block a slice; persistent
// and double-buffered; scores on the tensor cores). Each was right and
// bitwise repeatable, and each was slower than this design on every
// instance: with a slice in shared memory two to four blocks share an SM
// and a cross cache takes two or more rounds of them, so the reductions,
// the cluster barriers (each waiting on the slowest rank's copies) and P.V
// ran with no copies of that SM in flight.
#include "common.cuh"

#include <float.h>

namespace {

using namespace jl;

constexpr int kWarps = kThreads / 32;

// the 8 cache elements a lane reads at once: 16 bytes of bf16, 8 of int8
template <typename T> struct Lane;
template <> struct Lane<bf16> { using Raw = uint4; static constexpr bool kQuant = false; };
template <> struct Lane<int8_t> { using Raw = uint2; static constexpr bool kQuant = true; };

// key rows in flight per lane: 64 bytes a lane (eight int8 rows; four at
// Tq > 2, where the query rows take the registers)
template <typename T, int TQ>
constexpr int kRows = Lane<T>::kQuant && TQ <= 2 ? 8 : 4;
// blocks an SM the registers must allow: three at Tq = 1 (the whole grid
// resident at the decode shapes), two above (without a bound ptxas held Tq
// 4 to 80 registers and spilled; three held Tq 2 to 80 and spilled)
template <int TQ>
constexpr int kMinBlocks = TQ == 1 ? 3 : 2;

__device__ inline void unpack8(const uint2& u, float (&f)[8]) {
  int8x4_to_f32(u.x, f);
  int8x4_to_f32(u.y, f + 4);
}

__device__ inline void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// q [B*H, Tq, DH] bf16, k/v [B*H, Tk, DH] T, ks/vs [B*H, Tk] f32 (int8 only),
// lens [B] i32 -> out [B*H, Tq, DH] f32
template <typename T, int DH, int TQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TQ>)
decode_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                        const float* __restrict__ ks, const T* __restrict__ v,
                        const float* __restrict__ vs, const int* __restrict__ lens,
                        float* __restrict__ out, int H, int Tq, int Tk, float scale) {
  using Raw = typename Lane<T>::Raw;
  constexpr bool kQuant = Lane<T>::kQuant;
  constexpr int kUnroll = kRows<T, TQ>;
  extern __shared__ __align__(16) float sm[];
  constexpr int LPK = DH / 8;   // lanes per key row
  constexpr int KPW = 32 / LPK; // key rows per warp and step
  float* s = sm;                        // [TQ][Tk] scores, then probabilities
  float* red = sm + TQ * Tk;            // [kWarps][TQ] max / sum partials
  float* acc_s = red + kWarps * TQ;     // [kWarps][TQ][DH] P.V partials
  float* vss = acc_s + kWarps * TQ * DH;  // [Tk] vs of the valid prefix (int8)

  const int bh = blockIdx.x, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, part = lane % LPK;
  const int len = min(lens[b], Tk);
  const int n = len > 0 ? len : Tk;  // keys that can carry probability
  const T* kb = k + (size_t)bh * Tk * DH;
  const T* vb = v + (size_t)bh * Tk * DH;
  const float* ksb = kQuant ? ks + (size_t)bh * Tk : nullptr;
  const float* vsb = kQuant ? vs + (size_t)bh * Tk : nullptr;

  // pass 1: scores of the valid prefix
  float qf[TQ][8];
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tq) u = *reinterpret_cast<const uint4*>(q + ((size_t)bh * Tq + t) * DH + part * 8);
    unpack8(u, qf[t]);
  }
  float mx[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) mx[t] = -FLT_MAX;
  if (len == 0) {
    for (int i = threadIdx.x; i < TQ * Tk; i += kThreads) s[i] = -FLT_MAX;
    if constexpr (kQuant)
      for (int i = threadIdx.x; i < Tk; i += kThreads) vss[i] = vsb[i];
  } else {
    constexpr int step = kWarps * KPW;
    // the loop bound is uniform over the warp (the shuffles need all lanes)
    for (int base = warp * KPW; base < n; base += step * kUnroll) {
      const int k0 = base + sub;
      Raw raw[kUnroll];
      float sc[kUnroll];  // the score factor: 1/sqrt(dh), times ks[key] for int8
      float vsk[kUnroll];  // vs[key] (int8), read beside ks, kept in shared memory
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = k0 + u * step;
        raw[u] = Raw{};
        sc[u] = scale;
        vsk[u] = 0.f;
        if (key < n) {
          raw[u] = *reinterpret_cast<const Raw*>(kb + (size_t)key * DH + part * 8);
          if constexpr (kQuant) {
            sc[u] = ksb[key] * scale;
            vsk[u] = vsb[key];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = k0 + u * step;
        float kf[8];
        unpack8(raw[u], kf);
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) d += qf[t][j] * kf[j];
#pragma unroll
          for (int o = 1; o < LPK; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          d *= sc[u];
          if (key < n) {
            mx[t] = fmaxf(mx[t], d);
            if (part == 0) s[t * Tk + key] = d;
          }
        }
        if (kQuant && key < n && part == 0) vss[key] = vsk[u];
      }
    }
  }
  // pass 2's first V rows, requested now: they arrive during the reductions
  constexpr int step = kWarps * KPW;
  Raw vraw[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int key = warp * KPW + sub + u * step;
    vraw[u] = Raw{};
    if (key < n) vraw[u] = *reinterpret_cast<const Raw*>(vb + (size_t)key * DH + part * 8);
  }
  // row max over the block
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    float m = mx[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp * TQ + t] = m;
  }
  __syncthreads();
  float m_row[TQ], l_row[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    float m = red[t];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * TQ + t]);
    m_row[t] = m;
  }
  __syncthreads();  // every thread has read red
  // row sum of exp(s - max)
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    float l = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) l += expf(s[t * Tk + i] - m_row[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) red[warp * TQ + t] = l;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[w * TQ + t];
    l_row[t] = l;
  }
  // normalised probabilities (times vs for int8), rounded to bf16, in place
#pragma unroll
  for (int t = 0; t < TQ; ++t)
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float p = expf(s[t * Tk + i] - m_row[t]) / l_row[t];
      if constexpr (kQuant) p *= vss[i];
      s[t * Tk + i] = round_bf16(p);
    }
  __syncthreads();

  // pass 2: P.V over the same keys
  float acc[TQ][8];
#pragma unroll
  for (int t = 0; t < TQ; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
  {
    // the loop bound is uniform over the warp (the shuffles need all lanes)
    for (int base = warp * KPW; base < n; base += step * kUnroll) {
      const int k0 = base + sub;
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // this step's rows arrived; the next step's are requested before
        // this step's are summed
        const int next = k0 + u * step + step * kUnroll;
        raw[u] = vraw[u];
        vraw[u] = Raw{};
        if (next < n) vraw[u] = *reinterpret_cast<const Raw*>(vb + (size_t)next * DH + part * 8);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = k0 + u * step;
        if (key < n) {
          float vf[8];
          unpack8(raw[u], vf);
#pragma unroll
          for (int t = 0; t < TQ; ++t) {
            const float p = s[t * Tk + key];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[t][j] += p * vf[j];
          }
        }
      }
    }
  }
  // lanes holding the same 8 dims (same `part`) -> one sum per warp
#pragma unroll
  for (int t = 0; t < TQ; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = acc[t][j];
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (sub == 0) acc_s[(warp * TQ + t) * DH + part * 8 + j] = a;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < Tq * DH; i += kThreads) {
    const int t = i / DH, d = i % DH;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += acc_s[(w * TQ + t) * DH + d];
    out[((size_t)bh * Tq + t) * DH + d] = a;
  }
}

template <typename T, int DH, int TQ>
int launch(const bf16* q, const T* k, const float* ks, const T* v, const float* vs,
           const int* lens, float* out, int B, int H, int Tq, int Tk, float scale,
           cudaStream_t stream) {
  const size_t smem = ((size_t)TQ * Tk + kWarps * TQ + (size_t)kWarps * TQ * DH + Tk) * 4;
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, DH, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, DH, TQ><<<B * H, kThreads, smem, stream>>>(q, k, ks, v, vs, lens,
                                                                        out, H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_tq(const bf16* q, const T* k, const float* ks, const T* v, const float* vs,
              const int* lens, float* out, int B, int H, int Tq, int Tk, float scale,
              cudaStream_t stream) {
  if (Tq == 1) return launch<T, DH, 1>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  if (Tq == 2) return launch<T, DH, 2>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  if (Tq <= 4) return launch<T, DH, 4>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  if (Tq <= 8) return launch<T, DH, 8>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dh(const bf16* q, const T* k, const float* ks, const T* v, const float* vs,
              const int* lens, float* out, int B, int H, int Tq, int Tk, int dh, float scale,
              cudaStream_t stream) {
  if (dh == 64) return launch_tq<T, 64>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  if (dh == 128)
    return launch_tq<T, 128>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int jl_decode_attention(const bf16* q, const bf16* k, const bf16* v,
                                   const int* lens, float* out, int B, int H, int Tq, int Tk,
                                   int dh, float scale, cudaStream_t stream) {
  return launch_dh<bf16>(q, k, nullptr, v, nullptr, lens, out, B, H, Tq, Tk, dh, scale, stream);
}

extern "C" int jl_decode_attention_int8(const bf16* q, const int8_t* k, const float* ks,
                                        const int8_t* v, const float* vs, const int* lens,
                                        float* out, int B, int H, int Tq, int Tk, int dh,
                                        float scale, cudaStream_t stream) {
  return launch_dh<int8_t>(q, k, ks, v, vs, lens, out, B, H, Tq, Tk, dh, scale, stream);
}
