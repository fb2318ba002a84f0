// P1: the log-mel spectrogram with the DFT as three bf16 tensor-core
// products, the A/B probe of examples/profile_frontend_precision.py
// (_kernel_split under its pallas_call). Its partner in that A/B is K1,
// csrc/log_mel_tf32.cu.
#include "common.cuh"

namespace {

constexpr int TF = 64;  // frames per block
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
// frames of out[b, m, :]: log(max(., floor)) * f32(1/ln 10), the probe's form.
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
      out[((size_t)b * num_mels + m) * T + t] = __fmul_rn(logf(v), kInvLn10);
    }
  }
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
// Design: one block per (64 frames, utterance), the frames' reflect-padded
// segment staged as two bf16 arrays, hi = bf16(x) and
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
// stored to shared memory for the mel/log epilogue above.
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

  mel_log_epilogue(pw, ldp, mel, out, b, t0, T, n_freqs, num_mels, log_floor);
}

}  // namespace

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
