// K6: flash attention forward with log-sum-exp; K8: its backward (dQ; dK, dV).
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
// and lo = bf16(x - hi), two mma.sync each, which carries them to ~2^-16.
// A single rounding is not enough there: each row of dS sums to zero
// (sum_j P_j (dP_j - delta) = 0) and dO changes sign along the queries, so
// these products are small differences of large terms.
//
// What bounds it on the H100: tensor-core work. At B=16, T=750, H=8, dh=64
// the forward is 4*B*H*T^2*dh = 18.4 GFLOP over ~25 MB of q/k/v/out, and
// the backward needs 10*B*H*T^2*dh (five T x T x dh products), both far
// above the card's 295 FLOP/byte ridge. This backward executes 20*B*H*T^2*dh:
// S and dP are formed in both launches, and the three products with P or
// dS as operand run twice (hi and lo).
//
// Design (simple first; wgmma + TMA is later work). Each block has 4 warps
// and owns 64 rows; each warp owns 16 of them and issues
// mma.sync.m16n8k16 bf16 -> f32 (the raw PTX form, so the accumulator
// layout is known and the softmax statistics and the P / dS operands stay
// in registers: a score accumulator C is, element for element, the A
// operand of the next product).
//  * jl_flash_fwd: one block per (64-query tile, b*h). K and V tiles of 64
//    keys are staged in shared memory; online softmax with the running max
//    and sum in registers; out and lse written once.
//  * jl_flash_bwd, two launches and no atomics, so the result is
//    deterministic: (1) per (64-query tile, b*h): delta for the tile (also
//    written out for launch 2), then dQ over the key tiles; (2) per (64-key
//    tile, b*h): dK and dV over the query tiles.
#include "common.cuh"

namespace {

using namespace jl;

constexpr int FT = 128;     // threads per block: 4 warps
constexpr int TILE = 64;    // rows per block, keys (or queries) per tile
constexpr float NEG = -1e30f;

struct Strided {  // [B, T, H, DH] view: element (b, t, h, d)
  const bf16* p;
  long long sb;  // batch stride, elements
  int st;        // time stride, elements
  __device__ const bf16* row(int b, int t, int h, int dh) const {
    return p + (size_t)b * sb + (size_t)t * st + (size_t)h * dh;
  }
};

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// (x, y) -> hi = bf16 pair, lo = bf16 pair of the remainders
__device__ inline void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d[0..3] += A (16 x 16, row) . B (16 x 8, col), bf16 operands, f32 sums
__device__ inline void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows [t0, t0 + TILE) of one head of a strided tensor -> shared tile
// dst[TILE][DH + kPad]; rows at or past `valid` are zero-filled
template <int DH>
__device__ inline void load_rows(const Strided& src, int b, int h, int t0, int valid,
                                 bf16* dst) {
  constexpr int vecs = DH / 8;
  constexpr int ld = DH + kPad;
  for (int i = threadIdx.x; i < TILE * vecs; i += FT) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < valid) v = *reinterpret_cast<const uint4*>(src.row(b, t0 + r, h, DH) + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// acc[n] (16 rows x 8 cols each, n < N) += A[16 rows of a, K = DH] . B^T where
// B is `N * 8` rows of b starting at row b0 (both shared, row stride DH + kPad):
// the "rows times rows" product (Q K^T, dO V^T, K Q^T, V dO^T)
template <int DH, int N>
__device__ inline void rows_x_rows(const bf16* a, int a0, const bf16* bm, int b0,
                                   float (&acc)[N][4]) {
  constexpr int ld = DH + kPad;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kc = 0; kc < DH; kc += 16) {
    const bf16* ar = a + (a0 + g) * ld + kc + t * 2;
    const uint32_t x0 = ld32(ar), x1 = ld32(ar + 8 * ld), x2 = ld32(ar + 8),
                   x3 = ld32(ar + 8 * ld + 8);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* br = bm + (b0 + n * 8 + g) * ld + kc + t * 2;
      mma16816(acc[n], x0, x1, x2, x3, ld32(br), ld32(br + 8));
    }
  }
}

// acc[nd] (16 rows x 8 of DH columns) += P . M where P is 16 x (16 * KC) held
// as score accumulators p[2 * KC][4] (C layout == A layout) and M is rows
// [m0, m0 + 16 * KC) of a shared tile [*, DH + kPad]: the "P times rows"
// product (P V, dS K, P^T dO, dS^T Q)
template <int DH, int KC>
__device__ inline void p_x_rows(const float (&p)[2 * KC][4], const bf16* m, int m0,
                                float (&acc)[DH / 8][4]) {
  constexpr int ld = DH + kPad;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const uint32_t x0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t x1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t x2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t x3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* mr = m + (m0 + kk * 16 + t * 2) * ld + g;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const bf16* c = mr + nd * 8;
      mma16816(acc[nd], x0, x1, x2, x3, pack_bf16_raw(c[0], c[ld]),
               pack_bf16_raw(c[8 * ld], c[9 * ld]));
    }
  }
}

// p_x_rows for an operand that must keep more than bf16's 8 bits (P and dS
// in the backward): each
// A fragment is split into hi = bf16(p) and lo = bf16(p - hi), and both
// products accumulate into acc
template <int DH, int KC>
__device__ inline void p_x_rows_split(const float (&p)[2 * KC][4], const bf16* m, int m0,
                                      float (&acc)[DH / 8][4]) {
  constexpr int ld = DH + kPad;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    const bf16* mr = m + (m0 + kk * 16 + t * 2) * ld + g;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const bf16* c = mr + nd * 8;
      const uint32_t b0 = pack_bf16_raw(c[0], c[ld]), b1 = pack_bf16_raw(c[8 * ld], c[9 * ld]);
      mma16816(acc[nd], hi[0], hi[1], hi[2], hi[3], b0, b1);
      mma16816(acc[nd], lo[0], lo[1], lo[2], lo[3], b0, b1);
    }
  }
}

// ----------------------------------------------------------------- forward

template <int DH>
__global__ void __launch_bounds__(FT)
flash_fwd_kernel(Strided q, Strided k, Strided v, const int* __restrict__ lens,
                 bf16* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                 int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = DH + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE * ld;
  bf16* vs = ks + TILE * ld;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int kv_len = max(0, min(lens[b], Tk));
  int n_tiles = ceil_div(kv_len, TILE);
  if (causal) n_tiles = min(n_tiles, ceil_div(q0 + TILE, TILE));

  load_rows<DH>(q, b, h, q0, Tq, qs);

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows r0 + g and r0 + g + 8
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // previous readers of ks / vs are done (and qs is loaded)
    load_rows<DH>(k, b, h, k0, Tk, ks);
    load_rows<DH>(v, b, h, k0, Tk, vs);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    rows_x_rows<DH, 8>(qs, r0, ks, 0, s);

    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + t * 2 + (i & 1), r = i >> 1;
        const bool ok = key < kv_len && (!causal || key <= qrow[r]);
        s[n][i] = ok ? s[n][i] * scale : NEG;
        mt[r] = fmaxf(mt[r], s[n][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];  // per-thread partial sums; reduced over the quad at the end
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        s[n][i] = expf(s[n][i] - m[r]);
        l[r] += s[n][i];
      }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    p_x_rows<DH, 4>(s, vs, 0, o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Tq) continue;
    bf16* orow = out + (((size_t)b * Tq + qrow[r]) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
    if (t == 0) lse[(size_t)bh * Tq + qrow[r]] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// --------------------------------------------------------- backward: dQ

// also writes delta[bh][q] = rowsum(dO * O) for the dK/dV launch
template <int DH>
__global__ void __launch_bounds__(FT)
flash_bwd_dq_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                    const float* __restrict__ lse, const int* __restrict__ lens,
                    bf16* __restrict__ dq, float* __restrict__ delta, int H, int Tq, int Tk,
                    int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = DH + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TILE * ld;
  bf16* ks = dos + TILE * ld;
  bf16* vs = ks + TILE * ld;
  float* lse_s = reinterpret_cast<float*>(vs + TILE * ld);
  float* dl_s = lse_s + TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int kv_len = max(0, min(lens[b], Tk));
  int n_tiles = ceil_div(kv_len, TILE);
  if (causal) n_tiles = min(n_tiles, ceil_div(q0 + TILE, TILE));

  load_rows<DH>(q, b, h, q0, Tq, qs);
  load_rows<DH>(dout, b, h, q0, Tq, dos);
  {  // delta: two threads per row, DH / 2 products each
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + r < Tq) {
      const bf16* orow = o.row(b, q0 + r, h, DH) + half * (DH / 2);
      const bf16* drow = dout.row(b, q0 + r, h, DH) + half * (DH / 2);
      for (int c = 0; c < DH / 2; ++c)
        acc += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      lse_s[r] = q0 + r < Tq ? fmaxf(lse[(size_t)bh * Tq + q0 + r], -1e29f) : 0.f;
      if (q0 + r < Tq) delta[(size_t)bh * Tq + q0 + r] = acc;
    }
  }
  __syncthreads();
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float lr[2] = {lse_s[r0 + g], lse_s[r0 + g + 8]};
  const float dr[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TILE;
    __syncthreads();
    load_rows<DH>(k, b, h, k0, Tk, ks);
    load_rows<DH>(v, b, h, k0, Tk, vs);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      rows_x_rows<DH, 4>(qs, r0, ks, half * 32, s);
      rows_x_rows<DH, 4>(dos, r0, vs, half * 32, dp);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + half * 32 + n * 8 + t * 2 + (i & 1), r = i >> 1;
          const bool ok = key < kv_len && (!causal || key <= qrow[r]);
          const float p = ok ? expf(s[n][i] * scale - lr[r]) : 0.f;
          s[n][i] = p * (dp[n][i] - dr[r]);  // dS
        }
      p_x_rows_split<DH, 2>(s, ks, half * 32, acc);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Tq) continue;
    bf16* row = dq + (((size_t)b * Tq + qrow[r]) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + t * 2) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ----------------------------------------------------- backward: dK, dV

template <int DH>
__global__ void __launch_bounds__(FT)
flash_bwd_dkv_kernel(Strided q, Strided k, Strided v, Strided dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Tq, int Tk, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = DH + kPad;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE * ld;
  bf16* qs = vs + TILE * ld;
  bf16* dos = qs + TILE * ld;
  float* lse_s = reinterpret_cast<float*>(dos + TILE * ld);
  float* dl_s = lse_s + TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int kv_len = max(0, min(lens[b], Tk));
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  float ak[DH / 8][4], av[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) ak[n][i] = av[n][i] = 0.f;

  if (k0 < kv_len) {  // tiles wholly past kv_len keep exact zeros
    load_rows<DH>(k, b, h, k0, Tk, ks);
    load_rows<DH>(v, b, h, k0, Tk, vs);
    const int n_qt = ceil_div(Tq, TILE);
    for (int jq = causal ? k0 / TILE : 0; jq < n_qt; ++jq) {
      const int q0 = jq * TILE;
      __syncthreads();
      load_rows<DH>(q, b, h, q0, Tq, qs);
      load_rows<DH>(dout, b, h, q0, Tq, dos);
      for (int r = threadIdx.x; r < TILE; r += FT) {
        const bool in = q0 + r < Tq;
        lse_s[r] = in ? fmaxf(lse[(size_t)bh * Tq + q0 + r], -1e29f) : 0.f;
        dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 queries at a time
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
        rows_x_rows<DH, 4>(ks, r0, qs, half * 32, s);    // S^T: keys x queries
        rows_x_rows<DH, 4>(vs, r0, dos, half * 32, dp);  // dP^T
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qc = half * 32 + n * 8 + t * 2 + (i & 1), key = krow[i >> 1];
            const int qi = q0 + qc;
            const bool ok = key < kv_len && qi < Tq && (!causal || key <= qi);
            const float p = ok ? expf(s[n][i] * scale - lse_s[qc]) : 0.f;
            s[n][i] = p;
            dp[n][i] = p * (dp[n][i] - dl_s[qc]);  // dS^T
          }
        p_x_rows_split<DH, 2>(s, dos, half * 32, av);  // dV += P^T dO
        p_x_rows_split<DH, 2>(dp, qs, half * 32, ak);  // dK += dS^T Q
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= Tk) continue;
    const size_t at = (((size_t)b * Tk + krow[r]) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8 + t * 2) =
          pack_bf16(ak[n][2 * r] * scale, ak[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8 + t * 2) =
          pack_bf16(av[n][2 * r], av[n][2 * r + 1]);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int DH>
int launch_fwd(Strided q, Strided k, Strided v, const int* lens, bf16* out, float* lse, int B,
               int H, int Tq, int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)TILE * (DH + kPad) * 2;
  int err = set_smem(flash_fwd_kernel<DH>, smem);
  if (err) return err;
  dim3 grid(ceil_div(Tq, TILE), B * H);
  flash_fwd_kernel<DH><<<grid, FT, smem, stream>>>(q, k, v, lens, out, lse, H, Tq, Tk, causal,
                                                   scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(Strided q, Strided k, Strided v, Strided o, Strided dout, const float* lse,
               const int* lens, bf16* dq, bf16* dk, bf16* dv, float* delta, int B, int H,
               int Tq, int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)TILE * (DH + kPad) * 2 + 2 * TILE * sizeof(float);
  int err = set_smem(flash_bwd_dq_kernel<DH>, smem);
  if (err) return err;
  err = set_smem(flash_bwd_dkv_kernel<DH>, smem);
  if (err) return err;
  flash_bwd_dq_kernel<DH><<<dim3(ceil_div(Tq, TILE), B * H), FT, smem, stream>>>(
      q, k, v, o, dout, lse, lens, dq, delta, H, Tq, Tk, causal, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dkv_kernel<DH><<<dim3(ceil_div(Tk, TILE), B * H), FT, smem, stream>>>(
      q, k, v, dout, lse, delta, lens, dk, dv, H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v: base pointer, batch stride, time stride (elements); out [B, Tq, H, dh]
// and lse [B*H, Tq] are contiguous
extern "C" int jl_flash_fwd(const bf16* q, long long q_sb, int q_st, const bf16* k,
                            long long k_sb, int k_st, const bf16* v, long long v_sb, int v_st,
                            const int* lens, bf16* out, float* lse, int B, int H, int Tq,
                            int Tk, int dh, int causal, float scale, cudaStream_t stream) {
  const Strided sq{q, q_sb, q_st}, sk{k, k_sb, k_st}, sv{v, v_sb, v_st};
  if (dh == 64) return launch_fwd<64>(sq, sk, sv, lens, out, lse, B, H, Tq, Tk, causal, scale, stream);
  if (dh == 128) return launch_fwd<128>(sq, sk, sv, lens, out, lse, B, H, Tq, Tk, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// out and dout are contiguous [B, Tq, H, dh]; dq / dk / dv contiguous like
// out; delta [B*H, Tq] f32 scratch
extern "C" int jl_flash_bwd(const bf16* q, long long q_sb, int q_st, const bf16* k,
                            long long k_sb, int k_st, const bf16* v, long long v_sb, int v_st,
                            const bf16* o, const bf16* dout, const float* lse, const int* lens,
                            bf16* dq, bf16* dk, bf16* dv, float* delta, int B, int H, int Tq,
                            int Tk, int dh, int causal, float scale, cudaStream_t stream) {
  const Strided sq{q, q_sb, q_st}, sk{k, k_sb, k_st}, sv{v, v_sb, v_st};
  const Strided so{o, (long long)Tq * H * dh, H * dh}, sd{dout, (long long)Tq * H * dh, H * dh};
  if (dh == 64)
    return launch_bwd<64>(sq, sk, sv, so, sd, lse, lens, dq, dk, dv, delta, B, H, Tq, Tk,
                          causal, scale, stream);
  if (dh == 128)
    return launch_bwd<128>(sq, sk, sv, so, sd, lse, lens, dq, dk, dv, delta, B, H, Tq, Tk,
                           causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
