// K1: fused log-mel spectrogram, f32 end to end.
//
// Replaces frontend/pallas_frontend.py::fused_log_mel_raw (_logmel_kernel)
// of the JAX package: reflect-pad by n_fft/2, hop-framed periodic-Hann DFT
// as a matrix product, power, mel product, log10(max(., floor)); only the
// [B, num_mels, T] log-mel leaves the kernel.
//
// What bounds it on the H100: arithmetic in the CUDA cores. The DFT has to
// be full f32 (TF32 or bf16 products leave ~0.1-0.3 absolute error at deep
// spectral valleys against the 2e-4 bar), so the tensor cores are out and
// the 2 x 400 x 201 FMAs per frame run at f32 FMA rate; the signal itself is
// only 1.9 MB per 30 s utterance.
//
// Design: one block per (64-frame tile, utterance). The block stages the
// reflect-padded signal segment its frames cover (frame t starts at t*hop:
// no per-frame copies, no row-shifted views) and streams the windowed
// cos/sin basis through shared memory in 32-sample chunks; each thread
// keeps a 4-frame x 4-frequency register tile of (re, im) sums. The power
// spectrum of the tile stays in shared memory for the mel product, so
// neither the DFT output nor the power spectrum reaches device memory.
//
// P1, jl_log_mel_bf16x3 below: the same function with the DFT as three bf16
// tensor-core products, the A/B probe of examples/profile_frontend_precision.py
// (_kernel_split under its pallas_call). It shares K1's segment staging and
// its mel/log epilogue; its own note is above its kernel.
#include "common.cuh"

namespace {

constexpr int TF = 64;  // frames per block
constexpr int FT = 64;  // frequencies per register pass
constexpr int NC = 32;  // basis rows (samples) per shared chunk
constexpr float kInvLn10 = 0.4342944819032518f;  // np.float32(1 / np.log(10))

// the reflect-padded (by n_fft/2) signal segment of frames t0 .. t0 + TF - 1:
// store(j, sample t0 * hop + j - pad), 0 past the signal (only past frame T)
template <typename Store>
__device__ inline void stage_segment(const float* __restrict__ x, int L, int t0, int hop,
                                     int pad, int seg_len, Store store) {
  for (int j = threadIdx.x; j < seg_len; j += jl::kThreads) {
    int i = t0 * hop + j - pad;
    if (i < 0) i = -i;
    if (i >= L) i = 2 * (L - 1) - i;
    store(j, (i >= 0 && i < L) ? x[i] : 0.f);
  }
}

// mel product + log of a tile's power pw [TF][ldp] (shared): thread -> one
// frame, every (kThreads/TF)-th mel; neighbouring threads write neighbouring
// frames of out[b, m, :]. kLog10: log10(max(., floor)) (K1); else
// log(max(., floor)) * f32(1/ln 10), the probe's form (P1).
template <bool kLog10>
__device__ inline void mel_log_epilogue(const float* pw, int ldp, const float* __restrict__ mel,
                                        float* __restrict__ out, int b, int t0, int T,
                                        int n_freqs, int num_mels, float log_floor) {
  const int f = threadIdx.x % TF;
  const int t = t0 + f;
  for (int m = threadIdx.x / TF; m < num_mels; m += jl::kThreads / TF) {
    const float* mrow = mel + (size_t)m * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(pw[f * ldp + k], __ldg(mrow + k), acc);
    if (t < T) {
      const float v = fmaxf(acc, log_floor);
      out[((size_t)b * num_mels + m) * T + t] = kLog10 ? log10f(v) : __fmul_rn(logf(v), kInvLn10);
    }
  }
}

// basis: [n_pad][2 * f_pad] f32, columns [0, f_pad) = window * cos,
// [f_pad, 2 f_pad) = -window * sin, zero past n_fft rows / n_freqs columns.
// mel: [num_mels][n_freqs] f32. out: [B][num_mels][T] f32.
__global__ void __launch_bounds__(jl::kThreads)
log_mel_kernel(const float* __restrict__ wav, const float* __restrict__ basis,
               const float* __restrict__ mel, float* __restrict__ out, int L, int T,
               int n_fft, int hop, int n_freqs, int num_mels, float log_floor) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_pad = jl::ceil_div(n_fft, NC) * NC;
  const int f_pad = jl::ceil_div(n_freqs, FT) * FT;
  const int seg_len = (TF - 1) * hop + n_pad;
  float* seg = reinterpret_cast<float*>(smem);
  float* bc = seg + jl::align128(seg_len * 4) / 4;  // [NC][FT] cos chunk
  float* bs = bc + NC * FT;                          // [NC][FT] sin chunk
  float* pw = bs + NC * FT;                          // [TF][f_pad + 1] power

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int pad = n_fft / 2;
  const float* x = wav + (size_t)b * L;

  stage_segment(x, L, t0, hop, pad, seg_len, [&](int j, float v) { seg[j] = v; });

  const int tx = threadIdx.x % 16;  // frequency group: 4 frequencies
  const int ty = threadIdx.x / 16;  // frame group: 4 frames
  const int ldp = f_pad + 1;
  for (int f0 = 0; f0 < f_pad; f0 += FT) {
    float re[4][4] = {}, im[4][4] = {};
    for (int n0 = 0; n0 < n_pad; n0 += NC) {
      __syncthreads();  // previous chunk consumed (and seg loaded)
      for (int i = threadIdx.x; i < NC * FT; i += jl::kThreads) {
        const int r = i / FT, c = i % FT;
        const float* brow = basis + (size_t)(n0 + r) * 2 * f_pad + f0 + c;
        bc[i] = brow[0];
        bs[i] = brow[f_pad];
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < NC; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = seg[(ty * 4 + i) * hop + n0 + k];
        const float4 c4 = *reinterpret_cast<const float4*>(bc + k * FT + tx * 4);
        const float4 s4 = *reinterpret_cast<const float4*>(bs + k * FT + tx * 4);
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], c[j], re[i][j]);
            im[i][j] = fmaf(a[i], s[j], im[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pw[(ty * 4 + i) * ldp + f0 + tx * 4 + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
  }
  __syncthreads();

  mel_log_epilogue<true>(pw, ldp, mel, out, b, t0, T, n_freqs, num_mels, log_floor);
}

// P1: the DFT as three bf16 tensor-core products, hi.hi + lo.hi + hi.lo.
//
// Replaces examples/profile_frontend_precision.py::_kernel_split, K1's
// bf16x3 A/B partner (the probe's record: the split drops lo.lo, ~1.5e-5
// of the spectrum's typical magnitude, which at deep spectral valleys is
// ~0.3 on the Whisper-normalized surface, against K1's 2e-4 bar).
//
// What bounds it on the H100: the three DFT products in bf16 (3 x 2 x n_fft
// x 2 n_freqs per frame, 92.6 G at 32 x 30 s: 0.094 ms at 989 TFLOP/s) plus
// the f32 mel product in the CUDA cores (3.1 G, 0.046 ms).
//
// Design: K1's block (64 frames of one utterance) and its segment staging,
// but the segment is staged as two bf16 arrays, hi = bf16(x) and
// lo = bf16(x - hi). Frame t is the row seg + (t - t0) * hop, so the frame
// matrix is read straight into wmma A fragments with leading dimension hop
// (hop % 8 == 0; fragments start at multiples of 16 frames and 16 samples,
// 32-byte aligned) and no frame is copied. The windowed basis comes cached
// as bf16 hi and lo, [n_k][2 f16] (cos | -sin, f16 = n_freqs rounded up to
// 16, zero past n_fft rows), for the B fragments. Each warp owns one
// 16-frame row and every other 16-frequency column of the cos and sin halves
// (7 fragment pairs at n_fft 400) and adds hi.hi, lo.hi, hi.lo into f32
// accumulators at every k16 step: products of bf16 values are exact, so
// only the order of the f32 sums differs from the plain version. The power
// re^2 + im^2 is formed in the fragments (a cos and a sin fragment of one
// type hold the same elements), rounded at each step as the probe does, and
// stored to shared memory for K1's mel/log epilogue.
constexpr int kPairs = 7;  // cos/sin fragment pairs a warp holds: n_freqs <= 224

// basis_hi / basis_lo: [n_k][2 f16] bf16; mel [num_mels][n_freqs] f32;
// out [B][num_mels][T] f32
__global__ void __launch_bounds__(jl::kThreads)
log_mel_bf16x3_kernel(const float* __restrict__ wav, const jl::bf16* __restrict__ basis_hi,
                      const jl::bf16* __restrict__ basis_lo, const float* __restrict__ mel,
                      float* __restrict__ out, int L, int T, int n_fft, int hop, int n_freqs,
                      int num_mels, float log_floor) {
  namespace wmma = jl::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_k = jl::ceil_div(n_fft, 16) * 16;
  const int f16 = jl::ceil_div(n_freqs, 16) * 16;
  const int ldb = 2 * f16, ldp = f16 + 4;
  const int seg_len = (TF - 1) * hop + n_k;
  const size_t seg_bytes = jl::align128((size_t)seg_len * 2);
  jl::bf16* seg_hi = reinterpret_cast<jl::bf16*>(smem);
  jl::bf16* seg_lo = reinterpret_cast<jl::bf16*>(smem + seg_bytes);
  float* pw = reinterpret_cast<float*>(smem + 2 * seg_bytes);  // [TF][ldp] power

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  stage_segment(wav + (size_t)b * L, L, t0, hop, n_fft / 2, seg_len, [&](int j, float v) {
    const jl::bf16 hi = __float2bfloat16(v);
    seg_hi[j] = hi;
    seg_lo[j] = __float2bfloat16(v - __bfloat162float(hi));
  });
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int rf = warp % 4;  // the warp's 16 frames
  const int ncf = f16 / 16;
  jl::FragC re[kPairs], im[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    wmma::fill_fragment(re[j], 0.f);
    wmma::fill_fragment(im[j], 0.f);
  }
  const jl::bf16* a_hi = seg_hi + (size_t)rf * 16 * hop;
  const jl::bf16* a_lo = seg_lo + (size_t)rf * 16 * hop;
  for (int k = 0; k < n_k; k += 16) {
    jl::FragA ahi, alo;
    wmma::load_matrix_sync(ahi, a_hi + k, hop);
    wmma::load_matrix_sync(alo, a_lo + k, hop);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int cf = warp / 4 + 2 * j;
      if (cf >= ncf) continue;  // warp-uniform
      const size_t at = (size_t)k * ldb + cf * 16;
      jl::FragB bhi, blo;
      wmma::load_matrix_sync(bhi, basis_hi + at, ldb);
      wmma::load_matrix_sync(blo, basis_lo + at, ldb);
      wmma::mma_sync(re[j], ahi, bhi, re[j]);
      wmma::mma_sync(re[j], alo, bhi, re[j]);
      wmma::mma_sync(re[j], ahi, blo, re[j]);
      wmma::load_matrix_sync(bhi, basis_hi + at + f16, ldb);
      wmma::load_matrix_sync(blo, basis_lo + at + f16, ldb);
      wmma::mma_sync(im[j], ahi, bhi, im[j]);
      wmma::mma_sync(im[j], alo, bhi, im[j]);
      wmma::mma_sync(im[j], ahi, blo, im[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int cf = warp / 4 + 2 * j;
    if (cf >= ncf) continue;
#pragma unroll
    for (int i = 0; i < re[j].num_elements; ++i)
      re[j].x[i] = __fadd_rn(__fmul_rn(re[j].x[i], re[j].x[i]), __fmul_rn(im[j].x[i], im[j].x[i]));
    wmma::store_matrix_sync(pw + (size_t)rf * 16 * ldp + cf * 16, re[j], ldp,
                            wmma::mem_row_major);
  }
  __syncthreads();

  mel_log_epilogue<false>(pw, ldp, mel, out, b, t0, T, n_freqs, num_mels, log_floor);
}

}  // namespace

extern "C" int jl_log_mel(const float* wav, const float* basis, const float* mel,
                          float* out, int B, int L, int T, int n_fft, int hop,
                          int n_freqs, int num_mels, float log_floor,
                          cudaStream_t stream) {
  const int n_pad = jl::ceil_div(n_fft, NC) * NC;
  const int f_pad = jl::ceil_div(n_freqs, FT) * FT;
  const int seg_len = (TF - 1) * hop + n_pad;
  const size_t smem = jl::align128(seg_len * 4) + 2 * NC * FT * 4 + (size_t)TF * (f_pad + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(jl::ceil_div(T, TF), B);
  log_mel_kernel<<<grid, jl::kThreads, smem, stream>>>(
      wav, basis, mel, out, L, T, n_fft, hop, n_freqs, num_mels, log_floor);
  return (int)cudaGetLastError();
}

extern "C" int jl_log_mel_bf16x3(const float* wav, const jl::bf16* basis_hi,
                                 const jl::bf16* basis_lo, const float* mel, float* out, int B,
                                 int L, int T, int n_fft, int hop, int n_freqs, int num_mels,
                                 float log_floor, cudaStream_t stream) {
  const int n_k = jl::ceil_div(n_fft, 16) * 16;
  const int f16 = jl::ceil_div(n_freqs, 16) * 16;
  if (hop % 8 || f16 / 16 > 2 * kPairs) return (int)cudaErrorInvalidValue;
  const int seg_len = (TF - 1) * hop + n_k;
  const size_t smem = 2 * jl::align128((size_t)seg_len * 2) + (size_t)TF * (f16 + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_bf16x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(jl::ceil_div(T, TF), B);
  log_mel_bf16x3_kernel<<<grid, jl::kThreads, smem, stream>>>(
      wav, basis_hi, basis_lo, mel, out, L, T, n_fft, hop, n_freqs, num_mels, log_floor);
  return (int)cudaGetLastError();
}
