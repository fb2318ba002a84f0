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
#include "common.cuh"

namespace {

constexpr int TF = 64;  // frames per block
constexpr int FT = 64;  // frequencies per register pass
constexpr int NC = 32;  // basis rows (samples) per shared chunk

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

  // signal segment of frames t0 .. t0 + TF - 1, reflect-padded by n_fft/2
  for (int j = threadIdx.x; j < seg_len; j += jl::kThreads) {
    int i = t0 * hop + j - pad;
    if (i < 0) i = -i;
    if (i >= L) i = 2 * (L - 1) - i;
    seg[j] = (i >= 0 && i < L) ? x[i] : 0.f;  // out of range only past frame T
  }

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

  // mel product + log10: thread -> one frame, every (kThreads/TF)-th mel;
  // neighbouring threads write neighbouring frames of out[b, m, :]
  const int f = threadIdx.x % TF;
  const int t = t0 + f;
  for (int m = threadIdx.x / TF; m < num_mels; m += jl::kThreads / TF) {
    const float* mrow = mel + (size_t)m * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(pw[f * ldp + k], __ldg(mrow + k), acc);
    if (t < T) out[((size_t)b * num_mels + m) * T + t] = log10f(fmaxf(acc, log_floor));
  }
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
