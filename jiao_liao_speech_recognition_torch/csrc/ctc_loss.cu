// jl_ctc_loss: the CTC loss of a training step, forward and backward.
//
// The port's own kernel: the JAX package's loss (ops/ctc_loss.py::ctc_loss)
// is a log-semiring lax.scan that XLA compiles into its train step, not a
// Pallas kernel. On the card it replaces F.ctc_loss, which copies the
// lengths to the host before it launches and so cannot sit inside a
// captured train step. Nothing here reads back to the host.
//
// Semantics are the JAX function's: log_probs f32 [B, T, V], labels int32
// [B, S] in [0, V), lengths int32 [B]; extended states u < U = 2S + 1 (blank,
// l1, blank, l2, ..., blank), state u valid while u < 2L + 1; the skip
// u-2 -> u allowed on a label state whose label differs from the one before;
// log space floored at -1e30 with logaddexp(a, b) = m + log1p(exp(min - m)),
// m = max(max(a, b), -1e30). Frame 0 always counts; frames 1 .. Tl - 1 run
// the recursion and the rest carry alpha through (Tl = the row's logit
// length clamped to [0, T]). nll = -logaddexp(alpha[2L], alpha[2L - 1]). A
// row whose label needs more frames than it has (L + repeats > Tl) returns
// 1e30 and a zero gradient.
//
// jl_ctc_loss_fwd, one launch: a block a row, the row's states over the
// block's threads, alpha in shared memory (two rows, swapped each frame).
// Each frame's alpha row is also written to the scratch [B, T, U] for the
// backward.
// jl_ctc_loss_bwd, two launches, no atomics, so every run sums in the same
// order and two runs are bitwise equal:
//   1. a block a row: the occupancy gamma[t, u] = d ll / d alpha[t, u],
//      carried backwards from the row's last frame as jax.grad carries it
//      through the scan (the beta recursion in linear space): each state's
//      share of the logaddexps that fed the next frame, with the weights
//      x / (1 + x) and 1 - x / (1 + x) of the inputs' difference (x =
//      exp(min - max)), never exp(alpha + beta - ll), whose three large
//      terms cancel (at T' = 750, |alpha| ~ 5,000 and an f32 ulp of it
//      costs the occupancy ~1e-4 relative). gamma is written over alpha in
//      the scratch; also, for each label, the first valid state that
//      carries it ([B, V] map, -1 where none) and each state's next state
//      of the same label ([B, U]).
//   2. a block a (frame, row): the dense gradient row [V] with respect to
//      the log-probs, -g[b] x the sum of gamma over the states of each label
//      in state order (the chain of step 1), and zero elsewhere.
//
// What bounds it on the H100: the recursion is T dependent steps of a few
// hundred states, so the two per-row launches are latency (a block
// synchronisation and one gathered load a frame), and only 2 x B blocks run.
// The bytes that have to move are the dense gradient's, B x T x V x 4 (208
// MB at B=16, T=750, V=4336: 0.062 ms at 3.35 TB/s); launch 2 writes them
// with every SM busy. The design is the simple one; the recursion's
// latency is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kInfeasibleNll = 1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), kNegInf);
  return m + log1pf(expf(fminf(a, b) - m));
}

// the row's extended labels and skip flags into shared memory -> the
// number of valid states 2L + 1; *lab_len and *last_frame set
__device__ int setup_row(const int* labels, const int* logit_len, const int* label_len, int b,
                         int T, int S, int blank, int* ext, unsigned char* skip, int* lab_len,
                         int* last_frame, bool* feasible) {
  const int U = 2 * S + 1;
  const int L = min(max(label_len[b], 0), S);
  const int Tl = min(max(logit_len[b], 0), T);
  const int* lab = labels + (long long)b * S;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const int s = u >> 1;
    ext[u] = (u & 1) ? lab[s] : blank;
    skip[u] = (u & 1) && s >= 1 && lab[s] != lab[s - 1];
  }
  int repeats = 0;
  for (int s = 1; s < L; ++s) repeats += lab[s] == lab[s - 1];
  *lab_len = L;
  *last_frame = max(Tl, 1) - 1;
  *feasible = Tl >= L + repeats;
  __syncthreads();
  return 2 * L + 1;
}

__device__ __forceinline__ float emission(const float* lp_t, const int* ext, int u, int V) {
  return lp_t[min(max(ext[u], 0), V - 1)];
}

__global__ void __launch_bounds__(kThreads) ctc_alpha_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels,
    const int* __restrict__ logit_len, const int* __restrict__ label_len,
    float* __restrict__ alpha, float* __restrict__ nll, float* __restrict__ ll_out, int T, int V,
    int S, int blank) {
  extern __shared__ float smem[];
  const int U = 2 * S + 1;
  float* a_prev = smem;
  float* a_cur = smem + U;
  int* ext = reinterpret_cast<int*>(smem + 2 * U);
  unsigned char* skip = reinterpret_cast<unsigned char*>(ext + U);
  const int b = blockIdx.x;
  int L, tlast;
  bool feasible;
  const int nv = setup_row(labels, logit_len, label_len, b, T, S, blank, ext, skip, &L, &tlast,
                           &feasible);
  const float* lp_b = lp + (long long)b * T * V;
  float* al_b = alpha + (long long)b * T * U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    float a = kNegInf;
    if (u == 0) a = emission(lp_b, ext, 0, V);
    if (u == 1 && L > 0) a = emission(lp_b, ext, 1, V);
    a_prev[u] = a;
    al_b[u] = a;
  }
  __syncthreads();
  for (int t = 1; t <= tlast; ++t) {
    const float* lp_t = lp_b + (long long)t * V;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      float a = kNegInf;
      if (u < nv) {
        const float p1 = u >= 1 ? a_prev[u - 1] : kNegInf;
        const float p2 = (u >= 2 && skip[u]) ? a_prev[u - 2] : kNegInf;
        a = lae(lae(a_prev[u], p1), p2) + emission(lp_t, ext, u, V);
      }
      a_cur[u] = a;
      al_b[(long long)t * U + u] = a;
    }
    __syncthreads();
    float* tmp = a_prev;
    a_prev = a_cur;
    a_cur = tmp;
  }
  if (threadIdx.x == 0) {
    const float last = a_prev[2 * L];
    const float prev = L > 0 ? a_prev[2 * L - 1] : kNegInf;
    const float ll = lae(last, prev);
    nll[b] = feasible ? -ll : kInfeasibleNll;
    ll_out[b] = feasible ? ll : kNegInf;
  }
}

// d logaddexp(a, b) / da and / db as jax.grad takes them through the JAX
// module's _logaddexp: from the inputs' difference d = min - max (x =
// exp(d)): x / (1 + x) to the smaller, 1 - x / (1 + x) to the larger, a
// half each on a tie
__device__ __forceinline__ void lae_weights(float a, float b, float* wa, float* wb) {
  const float m = fmaxf(fmaxf(a, b), kNegInf);
  const float x = expf(fminf(a, b) - m);
  const float small = x / (1.f + x), large = 1.f - small;
  if (a > b) {
    *wa = large;
    *wb = small;
  } else if (a < b) {
    *wa = small;
    *wb = large;
  } else {
    *wa = *wb = 0.5f;
  }
}

__global__ void __launch_bounds__(kThreads) ctc_adjoint_kernel(
    const int* __restrict__ labels, const int* __restrict__ logit_len,
    const int* __restrict__ label_len, float* __restrict__ ag, const float* __restrict__ ll_in,
    int* __restrict__ head, int* __restrict__ next, int T, int V, int S, int blank) {
  extern __shared__ float smem[];
  const int U = 2 * S + 1;
  float* adj = smem;            // d ll / d alpha[t + 1, u], then [t, u]
  float* a_row = smem + U;      // alpha[t, u]
  float* c_stay = smem + 2 * U;  // state v's share to u = v, v - 1, v - 2
  float* c_one = smem + 3 * U;
  float* c_two = smem + 4 * U;
  int* ext = reinterpret_cast<int*>(smem + 5 * U);
  unsigned char* skip = reinterpret_cast<unsigned char*>(ext + U);
  const int b = blockIdx.x;
  int L, tlast;
  bool feasible;
  const int nv = setup_row(labels, logit_len, label_len, b, T, S, blank, ext, skip, &L, &tlast,
                           &feasible);
  int* head_b = head + (long long)b * V;
  int* next_b = next + (long long)b * U;
  for (int v = threadIdx.x; v < V; v += blockDim.x) head_b[v] = -1;
  __syncthreads();  // the -1s are written before any state claims a label
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    int nx = -1;
    bool first = true;
    if (u < nv) {
      for (int w = u + 1; w < nv; ++w)
        if (ext[w] == ext[u]) {
          nx = w;
          break;
        }
      for (int w = 0; w < u; ++w)
        if (ext[w] == ext[u]) {
          first = false;
          break;
        }
      if (first && ext[u] >= 0 && ext[u] < V) head_b[ext[u]] = u;
    }
    next_b[u] = nx;
  }
  const bool live = ll_in[b] > kNegInf;
  float* ag_b = ag + (long long)b * T * U;
  // the last frame: ll = logaddexp(alpha[2L], alpha[2L - 1])
  float w_last = 1.f, w_prev = 0.f;
  if (L > 0) lae_weights(ag_b[(long long)tlast * U + 2 * L], ag_b[(long long)tlast * U + 2 * L - 1],
                         &w_last, &w_prev);
  else lae_weights(ag_b[(long long)tlast * U], kNegInf, &w_last, &w_prev);
  __syncthreads();  // every thread read the last frame's alpha before it is overwritten
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    float a = 0.f;
    if (live && u == 2 * L) a = w_last;
    if (live && L > 0 && u == 2 * L - 1) a = w_prev;
    adj[u] = a;
    ag_b[(long long)tlast * U + u] = a;
  }
  for (int t = tlast - 1; t >= 0; --t) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) a_row[u] = ag_b[(long long)t * U + u];
    __syncthreads();  // alpha[t] staged; adj of frame t + 1 complete
    for (int v = threadIdx.x; v < U; v += blockDim.x) {
      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (v < nv && adj[v] != 0.f) {
        const float p1 = v >= 1 ? a_row[v - 1] : kNegInf;
        const float p2 = (v >= 2 && skip[v]) ? a_row[v - 2] : kNegInf;
        float ws, w1, wi, w2;
        lae_weights(a_row[v], p1, &ws, &w1);
        lae_weights(lae(a_row[v], p1), p2, &wi, &w2);
        c0 = adj[v] * (wi * ws);
        c1 = adj[v] * (wi * w1);
        c2 = (v >= 2 && skip[v]) ? adj[v] * w2 : 0.f;
      }
      c_stay[v] = c0;
      c_one[v] = c1;
      c_two[v] = c2;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      float a = 0.f;
      if (u < nv) {
        a = c_stay[u];
        if (u + 1 < nv) a += c_one[u + 1];
        if (u + 2 < nv) a += c_two[u + 2];
      }
      adj[u] = a;
      ag_b[(long long)t * U + u] = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ctc_grad_kernel(
    const float* __restrict__ gamma, const int* __restrict__ head, const int* __restrict__ next,
    const float* __restrict__ ll_in, const float* __restrict__ gout,
    const int* __restrict__ logit_len, float* __restrict__ grad, int T, int V, int U) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int tlast = max(min(logit_len[b], T), 1) - 1;
  const bool active = t <= tlast && ll_in[b] > kNegInf;
  const float g = gout[b];
  const float* gam = gamma + ((long long)b * T + t) * U;
  const int* head_b = head + (long long)b * V;
  const int* next_b = next + (long long)b * U;
  float* row = grad + ((long long)b * T + t) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float val = 0.f;
    if (active) {
      int u = head_b[v];
      if (u >= 0) {
        float s = 0.f;
        for (; u >= 0; u = next_b[u]) s += gam[u];
        val = -g * s;
      }
    }
    row[v] = val;
  }
}

// shared memory of a row's block: `rows` float rows of U states, the
// extended labels and the skip flags
size_t row_smem(int S, int rows) {
  const size_t U = 2 * (size_t)S + 1;
  return rows * U * sizeof(float) + U * sizeof(int) + U;
}

int prepare(const void* kernel, size_t smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// log_probs f32 [B, T, V] contiguous; labels int32 [B, S]; lengths int32 [B];
// alpha f32 scratch [B, T, U]; nll, ll f32 [B] (ll = -1e30 for an infeasible
// row, the backward's mark)
extern "C" int jl_ctc_loss_fwd(const float* lp, const int* labels, const int* logit_len,
                               const int* label_len, float* alpha, float* nll, float* ll, int B,
                               int T, int V, int S, int blank, cudaStream_t stream) {
  if (B < 1 || T < 1 || V < 1 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = row_smem(S, 2);
  int err = prepare((const void*)ctc_alpha_kernel, smem);
  if (err) return err;
  ctc_alpha_kernel<<<B, kThreads, smem, stream>>>(lp, labels, logit_len, label_len, alpha, nll,
                                                  ll, T, V, S, blank);
  return (int)cudaGetLastError();
}

// alpha in, the occupancy out [B, T, U]; head int32 scratch [B, V], next
// int32 scratch [B, U]; gout f32 [B] (the gradient of each row's nll); grad
// f32 [B, T, V], written whole. lp is the forward's (the adjoint reads only
// alpha)
extern "C" int jl_ctc_loss_bwd(const float* lp, const int* labels, const int* logit_len,
                               const int* label_len, float* alpha, const float* ll,
                               const float* gout, int* head, int* next, float* grad, int B,
                               int T, int V, int S, int blank, cudaStream_t stream) {
  if (B < 1 || B > 65535 || T < 1 || V < 1 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = row_smem(S, 5);
  int err = prepare((const void*)ctc_adjoint_kernel, smem);
  if (err) return err;
  ctc_adjoint_kernel<<<B, kThreads, smem, stream>>>(labels, logit_len, label_len, alpha, ll, head,
                                                    next, T, V, S, blank);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ctc_grad_kernel<<<dim3(T, B), kThreads, 0, stream>>>(alpha, head, next, ll, gout, logit_len,
                                                       grad, T, V, 2 * S + 1);
  return (int)cudaGetLastError();
}
