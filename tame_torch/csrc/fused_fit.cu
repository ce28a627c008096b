// K3 fused_fit: the whole damped-CAVI fit in one thread block.
//
// Replaces tame/ops/fused_fit.py::_fused_fit_kernel.  It computes what that
// kernel computes — block-Gauss-Seidel phases with fresh global statistics,
// the natural parameter (corrected or not) with AR(1) prior coupling, the
// Cholesky solve/inverse under the diag/full/block policy, exact (n^2, T)
// residual diagnostics, the ELBO with trace correction and logdet entropy,
// and the tolerance/patience/divergence rule — but not its TPU plane layout:
//
//   * one CTA per fit; threads stride over the (node, time) factors of a
//     phase, over the n^2 T dyads of the diagnostics and over the n T
//     factors of the ELBO;
//   * X_mean / X_cov live in dynamic shared memory for the whole fit (opted
//     in past 48 KB with cudaFuncSetAttribute); the data tensors W0, W1 and
//     y0 are read from global memory, L2-resident at these sizes;
//   * a phase first writes every new (mu, Sigma) of its node block to a
//     shared scratch from the state before the phase, then applies the
//     damped write-back: mu_prev / mu_next in the natural parameter are the
//     pre-update means, as in the TPU kernel;
//   * sums over nodes are shared-memory loops (global statistics) and warp
//     shuffles + one shared pass (diagnostics);
//   * the stopping rule runs on thread 0 and is broadcast through shared
//     memory.  Once it fires the loop ends: the state is frozen and the
//     histories past the stop keep the caller's NaN, the same outcome as the
//     TPU kernel's masked iterations up to max_iter.
//
// Bound: latency of one SM.  The demo configuration (n=15, T=10, d=6) has
// only bs*T = 10 factors per phase and 15 dependent phases per iteration,
// so the kernel runs on one SM with most threads idle; its gain over the
// unfused loop is the ~600 launches per iteration it removes, not flops.
// Batching many fits across SMs is later work.
#include "chol.cuh"
#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kReduce = 6;  // sq, cross, tr(cov), prior0, priort, logdet
constexpr float kLog2Pi = 1.8378770664093453f;

// Global statistic layout per time step (r = (D-2)/2), sums over all nodes:
//   [0, r) U_k | [r, 2r) V_k | GUU_kl | GVV_kl | GVU_kl = V_k U_l |
//   c | dd | c V_k | dd U_k        with c = p b + q a, dd = q b + p a.
template <int D>
struct Layout {
  static constexpr int R = (D - 2) / 2;
  static constexpr int OU = 0, OV = R, OGUU = 2 * R, OGVV = 2 * R + R * R,
                       OGVU = 2 * R + 2 * R * R, OC = 2 * R + 3 * R * R,
                       OD = OC + 1, OCV = OC + 2, ODU = OC + 2 + R,
                       NS = OC + 2 + 2 * R;
};

size_t smem_floats(int n, int T, int d, int num_blocks) {
  const int r = (d - 2) / 2;
  const size_t ns = 2 + 4 * r + 3 * r * r;
  const size_t bs = n / num_blocks;
  const size_t per_factor = d + static_cast<size_t>(d) * d;
  return static_cast<size_t>(n) * T * per_factor  // X_mean, X_cov
         + bs * T * per_factor                     // phase scratch
         + T * ns                                  // global statistics
         + 5 * static_cast<size_t>(d) * d          // prior matrices
         + kMaxWarps * kReduce                     // block reduction
         + 1;                                      // running flag
}

template <int D>
__device__ float stat_term(int s, const float* x, float p, float q) {
  using L = Layout<D>;
  constexpr int R = L::R;
  const float* U = x + 2;
  const float* V = x + 2 + R;
  if (s < L::OV) return U[s];
  if (s < L::OGUU) return V[s - L::OV];
  if (s < L::OGVV) { s -= L::OGUU; return U[s / R] * U[s % R]; }
  if (s < L::OGVU) { s -= L::OGVV; return V[s / R] * V[s % R]; }
  if (s < L::OC) { s -= L::OGVU; return V[s / R] * U[s % R]; }
  const float c = p * x[1] + q * x[0];
  const float dd = q * x[1] + p * x[0];
  if (s == L::OC) return c;
  if (s == L::OD) return dd;
  if (s < L::ODU) return c * V[s - L::OCV];
  return dd * U[s - L::ODU];
}

template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w * K + k];
      v[k] = s;
    }
  }
}

// New (mu, Sigma) of factor (i, t) from the current state, into nm / nc.
template <int D>
__device__ void factor_update(const FusedFitArgs& a, const float* Xm,
                              const float* st, const float* pri, int i, int t,
                              float* nm, float* nc) {
  using L = Layout<D>;
  constexpr int R = L::R;
  const int n = a.n, T = a.T;
  const float p = a.p, q = a.q;
  const float* x = Xm + (static_cast<size_t>(i) * T + t) * D;
  const float* s = st + t * L::NS;
  const float* S0inv = pri;
  const float* Qinv = pri + D * D;
  const float* QP = pri + 2 * D * D;
  const float* PtQP = pri + 3 * D * D;

  // Observation precision from global statistics minus the node's own term
  // (cavi._P_from_partner_stats), lower triangle only, plus the prior.
  float A[D][D];
  const float c = static_cast<float>(n - 1);
  A[0][0] = p * c;
  A[1][1] = p * c;
  A[1][0] = q * c;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float sV = s[L::OV + k] - x[2 + R + k];
    const float sU = s[L::OU + k] - x[2 + k];
    A[2 + k][0] = p * sV;
    A[2 + R + k][0] = q * sU;
    A[2 + k][1] = q * sV;
    A[2 + R + k][1] = p * sU;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int l = 0; l <= k; ++l) {
      A[2 + k][2 + l] = p * (s[L::OGVV + k * R + l] - x[2 + R + k] * x[2 + R + l]);
      A[2 + R + k][2 + R + l] = p * (s[L::OGUU + k * R + l] - x[2 + k] * x[2 + l]);
    }
#pragma unroll
    for (int l = 0; l < R; ++l)
      A[2 + R + l][2 + k] = q * (s[L::OGVU + k * R + l] - x[2 + R + k] * x[2 + l]);
  }
#pragma unroll
  for (int r0 = 0; r0 < D; ++r0)
#pragma unroll
    for (int c0 = 0; c0 <= r0; ++c0) {
      float pr = (t == 0 ? S0inv[r0 * D + c0] : 0.f) +
                 (t > 0 ? Qinv[r0 * D + c0] : 0.f);
      pr += (t < T - 1 ? PtQP[r0 * D + c0] : 0.f);
      A[r0][c0] += pr;
    }

  // Natural parameter: data weights against the partners' means.
  float e[D];
  e[0] = a.eta_a[i * T + t];
  e[1] = a.eta_b[i * T + t];
  float eu[R], ev[R];
#pragma unroll
  for (int k = 0; k < R; ++k) eu[k] = ev[k] = 0.f;
  const float* w0 = a.W0 + static_cast<size_t>(i) * n * T + t;
  const float* w1 = a.W1 + static_cast<size_t>(i) * n * T + t;
  for (int j = 0; j < n; ++j) {
    const float w0j = w0[static_cast<size_t>(j) * T];
    const float w1j = w1[static_cast<size_t>(j) * T];
    const float* xj = Xm + (static_cast<size_t>(j) * T + t) * D;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      eu[k] += w0j * xj[2 + R + k];
      ev[k] += w1j * xj[2 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    e[2 + k] = eu[k];
    e[2 + R + k] = ev[k];
  }
  if (a.corrected) {
    const float ci = p * x[1] + q * x[0];
    const float di = q * x[1] + p * x[0];
    e[0] -= s[L::OC] - ci;
    e[1] -= s[L::OD] - di;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      e[2 + k] -= s[L::OCV + k] - ci * x[2 + R + k];
      e[2 + R + k] -= s[L::ODU + k] - di * x[2 + k];
    }
  }
  // AR(1) coupling to the pre-update neighbours in time.
#pragma unroll
  for (int r0 = 0; r0 < D; ++r0) {
    float pe = 0.f;
    if (t > 0) {
      const float* xp = x - D;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc += xp[j] * QP[r0 * D + j];
      pe = acc;
    }
    if (t < T - 1) {
      const float* xn = x + D;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc += xn[j] * QP[j * D + r0];
      pe += acc;
    }
    e[r0] += pe;
  }

  // Solve under the covariance-structure policy (cavi._SOLVERS).
  float inv_diag[D];
  if (a.structure == 0) {
    float pd[D];
#pragma unroll
    for (int k = 0; k < D; ++k) pd[k] = A[k][k];
    chol_factor<D>(A, inv_diag);
    float mu[D];
    chol_solve<D>(A, inv_diag, e, mu);
#pragma unroll
    for (int r0 = 0; r0 < D; ++r0) {
      nm[r0] = mu[r0];
#pragma unroll
      for (int c0 = 0; c0 < D; ++c0)
        nc[r0 * D + c0] = (r0 == c0) ? 1.f / (pd[r0] + 1e-8f) : 0.f;
    }
    return;
  }
  chol_factor<D>(A, inv_diag);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float col[D];
    chol_inverse_column<D>(A, inv_diag, j, col);
#pragma unroll
    for (int r0 = 0; r0 < D; ++r0) nc[r0 * D + j] = col[r0];
  }
  // Block policy zeroes the additive x multiplicative cross blocks; then
  // symmetrize + jitter (cavi._finalize_cov).
#pragma unroll
  for (int r0 = 0; r0 < D; ++r0)
#pragma unroll
    for (int c0 = r0; c0 < D; ++c0) {
      const bool cross = (r0 < 2) != (c0 < 2);
      float v = (a.structure == 2 && cross)
                    ? 0.f
                    : 0.5f * (nc[r0 * D + c0] + nc[c0 * D + r0]);
      if (r0 == c0) v += 1e-6f;
      nc[r0 * D + c0] = v;
      nc[c0 * D + r0] = v;
    }
#pragma unroll
  for (int r0 = 0; r0 < D; ++r0) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += nc[r0 * D + j] * e[j];
    nm[r0] = acc;
  }
}

// Per-factor ELBO terms of factor f = i*T + t, added into v[2..5].
template <int D>
__device__ void factor_elbo_terms(const float* Xm, const float* Xc,
                                  const float* pri, int f, int t, float* v) {
  const float* x = Xm + static_cast<size_t>(f) * D;
  const float* C = Xc + static_cast<size_t>(f) * D * D;
  const float* S0inv = pri;
  const float* Qinv = pri + D * D;
  const float* Phi = pri + 4 * D * D;
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) tr += C[k * D + k];
  v[2] += tr;
  if (t == 0) {
    float quad = 0.f, trace = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < D; ++r0)
#pragma unroll
      for (int c0 = 0; c0 < D; ++c0) {
        quad += x[r0] * S0inv[r0 * D + c0] * x[c0];
        trace += S0inv[r0 * D + c0] * C[c0 * D + r0];
      }
    v[3] += quad + trace;
  } else {
    const float* xp = x - D;
    float res[D];
#pragma unroll
    for (int r0 = 0; r0 < D; ++r0) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc += xp[j] * Phi[r0 * D + j];
      res[r0] = x[r0] - acc;
    }
    float quad = 0.f, trace = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < D; ++r0)
#pragma unroll
      for (int c0 = 0; c0 < D; ++c0) {
        quad += res[r0] * Qinv[r0 * D + c0] * res[c0];
        trace += Qinv[r0 * D + c0] * C[c0 * D + r0];
      }
    v[4] += quad + trace;
  }
  float A[D][D], inv_diag[D];
#pragma unroll
  for (int r0 = 0; r0 < D; ++r0)
#pragma unroll
    for (int c0 = 0; c0 <= r0; ++c0) A[r0][c0] = C[r0 * D + c0];
  v[5] += chol_factor<D>(A, inv_diag);
}

template <int D>
__global__ void __launch_bounds__(kThreads) fused_fit_kernel(FusedFitArgs a) {
  using L = Layout<D>;
  constexpr int R = L::R;
  extern __shared__ float smem[];
  const int n = a.n, T = a.T, nT = n * T;
  const int bs = n / a.num_blocks;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ns = a.corrected ? L::NS : L::OC;  // statistics in use

  float* Xm = smem;
  float* Xc = Xm + static_cast<size_t>(nT) * D;
  float* Nm = Xc + static_cast<size_t>(nT) * D * D;
  float* Nc = Nm + static_cast<size_t>(bs) * T * D;
  float* st = Nc + static_cast<size_t>(bs) * T * D * D;
  float* pri = st + T * L::NS;
  float* red = pri + 5 * D * D;
  float* running = red + kMaxWarps * kReduce;

  for (int k = tid; k < nT * D; k += nthr) Xm[k] = a.Xm0[k];
  for (int k = tid; k < nT * D * D; k += nthr) Xc[k] = a.Xc0[k];
  for (int k = tid; k < 5 * D * D; k += nthr) pri[k] = a.pri[k];
  // Stopping-rule state, live on thread 0 only.
  float prev = a.carry_elbo;
  int pat = a.carry_pat, n_done = 0;
  bool conv = false, div = false;
  if (tid == 0) *running = 1.f;
  __syncthreads();

  const float lr = a.lr, keep = 1.f - a.lr;
  for (int it = 0; it < a.max_iter; ++it) {
    if (*running == 0.f) break;  // uniform: written before a barrier

    for (int blk = 0; blk < a.num_blocks; ++blk) {
      const int start = blk * bs;
      // 1. Global sufficient statistics over all nodes, per time step.
      for (int k = tid; k < T * ns; k += nthr) {
        const int t = k / ns, s = k % ns;
        float acc = 0.f;
        for (int j = 0; j < n; ++j)
          acc += stat_term<D>(s, Xm + (static_cast<size_t>(j) * T + t) * D,
                              a.p, a.q);
        st[t * L::NS + s] = acc;
      }
      __syncthreads();
      // 2. Closed-form update of the block's factors into the scratch.
      for (int f = tid; f < bs * T; f += nthr) {
        const int t = f % T;
        factor_update<D>(a, Xm, st, pri, start + f / T, t, Nm + f * D,
                         Nc + static_cast<size_t>(f) * D * D);
      }
      __syncthreads();
      // 3. Damped write-back of the block's rows.
      float* xm = Xm + static_cast<size_t>(start) * T * D;
      float* xc = Xc + static_cast<size_t>(start) * T * D * D;
      for (int k = tid; k < bs * T * D; k += nthr)
        xm[k] = lr * Nm[k] + keep * xm[k];
      for (int k = tid; k < bs * T * D * D; k += nthr)
        xc[k] = lr * Nc[k] + keep * xc[k];
      __syncthreads();
    }

    // Exact diagnostics: dyadic residuals and per-factor ELBO terms.
    float v[kReduce] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < n * nT; k += nthr) {
      const int t = k % T, j = (k / T) % n, i = k / nT;
      if (i == j) continue;
      const float* xi = Xm + (static_cast<size_t>(i) * T + t) * D;
      const float* xj = Xm + (static_cast<size_t>(j) * T + t) * D;
      float uij = 0.f, uji = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < R; ++k2) {
        uij += xi[2 + k2] * xj[2 + R + k2];
        uji += xj[2 + k2] * xi[2 + R + k2];
      }
      const float e = a.y0[k] - ((xi[0] + xj[1]) + uij);
      const float eT =
          a.y0[(static_cast<size_t>(j) * n + i) * T + t] - ((xj[0] + xi[1]) + uji);
      v[0] += e * e;
      v[1] += e * eT;
    }
    for (int f = tid; f < nT; f += nthr)
      factor_elbo_terms<D>(Xm, Xc, pri, f, f % T, v);
    block_sum<kReduce>(v, red);

    if (tid == 0) {
      const float sq = v[0], cross = v[1];
      const float n_dyads = static_cast<float>(n * (n - 1) / 2 * T);
      float log_lik =
          -0.5f * ((a.p * sq + a.q * cross) + n_dyads * (a.logdet_R + 2.f * kLog2Pi));
      if (a.structure != 0) {
        const float corr = 0.1f * a.tr_rinv / static_cast<float>(D) *
                           (static_cast<float>(n - 1) * v[2]);
        log_lik -= 0.5f * corr;
      }
      const float prior0 = -0.5f * (v[3] + n * (a.logdet_S0 + D * kLog2Pi));
      const float priort = -0.5f * (v[4] + n * (T - 1) * (a.logdet_Q + D * kLog2Pi));
      const float entropy = 0.5f * (v[5] + nT * D * (1.f + kLog2Pi));
      const float elbo = log_lik + prior0 + priort + entropy;
      const float mse = 2.f * sq / static_cast<float>(n * (n - 1) * T);
      a.eh[it] = elbo;
      a.mh[it] = mse;
      // Tolerance x patience rule (cavi._fit_cavi_impl): a finite previous
      // ELBO is the "have a previous evaluation" signal.
      const float rel = fabsf(elbo - prev) / (fabsf(prev) + 1e-8f);
      const bool small = isfinite(prev) && rel < a.tol;
      pat = small ? pat + 1 : 0;
      conv = pat >= a.patience;
      div = !isfinite(elbo);
      prev = elbo;
      ++n_done;
      *running = (conv || div) ? 0.f : 1.f;
    }
    __syncthreads();
  }

  for (int k = tid; k < nT * D; k += nthr) a.Xm[k] = Xm[k];
  for (int k = tid; k < nT * D * D; k += nthr) a.Xc[k] = Xc[k];
  if (tid == 0) {
    a.stats[0] = static_cast<float>(n_done);
    a.stats[1] = conv ? 1.f : 0.f;
    a.stats[2] = div ? 1.f : 0.f;
    a.stats[3] = static_cast<float>(pat);
    a.stats[4] = prev;
  }
}

template <int D>
cudaError_t launch(const FusedFitArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_fit_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_fit_kernel<D><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

size_t tame_fused_fit_smem_bytes(int n, int T, int d, int num_blocks) {
  return smem_floats(n, T, d, num_blocks) * sizeof(float);
}

cudaError_t tame_fused_fit(const FusedFitArgs& a, int d, cudaStream_t stream) {
  const size_t smem = tame_fused_fit_smem_bytes(a.n, a.T, d, a.num_blocks);
  switch (d) {
#define TAME_CASE(DD) \
  case DD:            \
    return launch<DD>(a, smem, stream);
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
