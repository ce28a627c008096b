// K4 fused_smoother: the batched block-tridiagonal forward-backward
// smoother, one thread block per node trajectory.
//
// Replaces tame/ops/fused_smoother.py::_smoother_kernel, which puts 128
// nodes on the TPU's lanes and walks T with every d x d entry a vector
// plane.  At the smoothed fit's block phase (125 trajectories of T = 50,
// d = 10) that layout would leave the card almost idle, and one thread per
// node would spill its three live 10 x 10 matrices.  Here the parallelism
// comes from nodes (one block each: 125 per block phase, n per Jacobi
// sweep) and from within each d x d step:
//
//   * the node's working matrices live in shared memory (SmootherSmem,
//     5 d^2 + 5 d + 1 floats: 2,204 B at d = 10), independent of T;
//   * the d x d products give one output entry per thread;
//   * S_t is factored by chol_factor<D> (chol.cuh) on thread 0, and S_t^-1
//     is d unit-column solves, one column per thread.
//
// Memory trick kept from the TPU kernel: the forward pass writes S_t^-1
// into `cov` and c_t into `mean`; the backward pass reads them back and
// overwrites them in reverse order, so there is no device scratch.
// logdet = sum_t sum_k log(L_kk^2), accumulated over t in order.
//
// Bound: the latency of T dependent steps per node, each ~5 d^3 flops
// behind four block barriers and one serial d x d factorization; the
// output, (3 d^2 + 2 d) * 4 B per node-step, is far below what the memory
// system streams in that time.
#include "chol.cuh"
#include "kernels.h"

namespace {

template <int D>
struct SmootherSmem {
  float O[D][D];        // coupling block
  float Sinv[D][D];     // S_t^-1
  float M[D][D];        // O' S_{t-1}^-1 (forward), G_t = S_t^-1 O (backward)
  float S[D][D];        // S_t, then its factor (forward); G_t Sig_{t+1} (backward)
  float Sig[D][D];      // Sig_{t+1} (backward)
  float c[D];           // c_{t-1} (forward), c_t (backward)
  float c_new[D];       // c_t (forward)
  float mu[D];          // mu_{t+1}, then mu_t (backward)
  float rhs[D];         // c_t - O mu_{t+1} (backward)
  float inv_diag[D];    // 1 / L_kk of S_t
  float logdet;
};

// One thread per entry of a d x d product, in whole warps.
template <int D>
struct SmootherCfg {
  static constexpr int kThreads = ((D * D + 31) / 32) * 32;
};

template <int D>
__global__ void __launch_bounds__(SmootherCfg<D>::kThreads)
fused_smoother_kernel(const float* __restrict__ Dm, const float* __restrict__ O,
                      const float* __restrict__ b, float* __restrict__ mean,
                      float* __restrict__ cov, float* __restrict__ cross,
                      float* __restrict__ logdet_out, int T) {
  constexpr int DD = D * D;
  __shared__ SmootherSmem<D> s;
  const int tid = threadIdx.x;
  const bool entry = tid < DD;      // owns entry (i, j) of a d x d product
  const bool row = tid < D;         // owns row i of a d-vector
  const int i = tid / D, j = tid % D;
  const size_t node = blockIdx.x;
  const float* Dn = Dm + node * T * DD;
  const float* bn = b + node * T * D;
  float* mn = mean + node * T * D;
  float* cn = cov + node * T * DD;
  float* xn = cross + node * (T - 1) * DD;

  if (entry) {
    s.O[i][j] = O[tid];
    s.S[i][j] = Dn[tid];                        // S_0 = D_0
  }
  if (row) {
    s.c[tid] = bn[tid];                         // c_0 = b_0
    mn[tid] = bn[tid];
  }
  if (tid == 0) s.logdet = 0.f;
  __syncthreads();

  // ---- forward elimination: S_t^-1 -> cov[t], c_t -> mean[t] ----------
  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      if (entry) {                              // M = O' S_{t-1}^-1
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) acc += s.O[k][i] * s.Sinv[k][j];
        s.M[i][j] = acc;
      }
      __syncthreads();
      if (entry) {                              // S_t = D_t - M O
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) acc += s.M[i][k] * s.O[k][j];
        s.S[i][j] = Dn[static_cast<size_t>(t) * DD + tid] - acc;
      }
      if (row) {                                // c_t = b_t - M c_{t-1}
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) acc += s.M[tid][k] * s.c[k];
        const float v = bn[static_cast<size_t>(t) * D + tid] - acc;
        s.c_new[tid] = v;
        mn[static_cast<size_t>(t) * D + tid] = v;
      }
      __syncthreads();
      if (row) s.c[tid] = s.c_new[tid];
    }
    if (tid == 0) {                             // factor S_t in registers
      float A[D][D], inv_diag[D];
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q) A[r][q] = s.S[r][q];
      s.logdet += chol_factor<D>(A, inv_diag);
#pragma unroll
      for (int r = 0; r < D; ++r) {
        s.inv_diag[r] = inv_diag[r];
#pragma unroll
        for (int q = 0; q <= r; ++q) s.S[r][q] = A[r][q];
      }
    }
    __syncthreads();
    if (row) {                                  // column tid of S_t^-1
      float col[D];
      chol_inverse_column<D>(s.S, s.inv_diag, tid, col);
#pragma unroll
      for (int r = 0; r < D; ++r) {
        s.Sinv[r][tid] = col[r];
        cn[static_cast<size_t>(t) * DD + r * D + tid] = col[r];
      }
    }
    __syncthreads();
  }

  // ---- backward substitution (overwrites mean/cov in reverse) ----------
  // t = T-1: mu = S^-1 c, Sig = S^-1 (already in cov[T-1]).
  if (row) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) acc += s.Sinv[tid][k] * s.c[k];
    s.mu[tid] = acc;
    mn[static_cast<size_t>(T - 1) * D + tid] = acc;
  }
  if (entry) s.Sig[i][j] = s.Sinv[i][j];
  __syncthreads();
  for (int t = T - 2; t >= 0; --t) {
    if (entry) s.Sinv[i][j] = cn[static_cast<size_t>(t) * DD + tid];
    if (row) s.c[tid] = mn[static_cast<size_t>(t) * D + tid];
    __syncthreads();
    if (row) {                                  // rhs = c_t - O mu_{t+1}
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc += s.O[tid][k] * s.mu[k];
      s.rhs[tid] = s.c[tid] - acc;
    }
    if (entry) {                                // G = S_t^-1 O
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc += s.Sinv[i][k] * s.O[k][j];
      s.M[i][j] = acc;
    }
    __syncthreads();
    if (row) {                                  // mu_t = S_t^-1 rhs
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc += s.Sinv[tid][k] * s.rhs[k];
      s.mu[tid] = acc;
      mn[static_cast<size_t>(t) * D + tid] = acc;
    }
    if (entry) {                                // GS = G Sig_{t+1}
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc += s.M[i][k] * s.Sig[k][j];
      s.S[i][j] = acc;
      xn[static_cast<size_t>(t) * DD + tid] = -acc;
    }
    __syncthreads();
    if (entry) {                                // Sig_t = S_t^-1 + GS G'
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc += s.S[i][k] * s.M[j][k];
      const float v = s.Sinv[i][j] + acc;
      s.Sig[i][j] = v;
      cn[static_cast<size_t>(t) * DD + tid] = v;
    }
    __syncthreads();
  }
  if (tid == 0) logdet_out[node] = s.logdet;
}

}  // namespace

size_t tame_fused_smoother_smem_bytes(int d) {
  switch (d) {
#define TAME_CASE(DD) \
  case DD:            \
    return sizeof(SmootherSmem<DD>);
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return 0;
  }
}

cudaError_t tame_fused_smoother(const float* D, const float* O, const float* b,
                                float* mean, float* cov, float* cross,
                                float* logdet, int n, int T, int d,
                                cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (T < 1) return cudaErrorInvalidValue;
  switch (d) {
#define TAME_CASE(DD)                                                      \
  case DD:                                                                 \
    fused_smoother_kernel<DD><<<n, SmootherCfg<DD>::kThreads, 0, stream>>>( \
        D, O, b, mean, cov, cross, logdet, T);                             \
    break;
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
