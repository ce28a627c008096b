// Host-side launchers of the port's CUDA kernels.  Plain pointers and
// sizes only, so the .cu files never include PyTorch's headers; the one
// binding file (binding.cpp) checks tensors and calls these.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a d that
// has no instantiation).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// K1: mu = P^-1 eta and, when cov != nullptr, cov = P^-1.
// P (B, d, d), eta (B, d), mu (B, d), cov (B, d, d); float32, row-major.
cudaError_t tame_spd_solve_inv(const float* P, const float* eta, float* mu,
                               float* cov, int B, int d, cudaStream_t stream);

// K2: out[b] = log det P[b].  P (B, d, d) float32 row-major.
cudaError_t tame_logdet_spd(const float* P, float* out, int B, int d,
                            cudaStream_t stream);

// K3: the whole damped-CAVI fit in one thread block.
struct FusedFitArgs {
  const float* W0;     // (n, n, T)  p y0 + q y1
  const float* W1;     // (n, n, T)  q y0 + p y1
  const float* eta_a;  // (n, T)     row sums of W0
  const float* eta_b;  // (n, T)     row sums of W1
  const float* y0;     // (n, n, T)  Y[..., 0]
  const float* Xm0;    // (n, T, d)  initial means
  const float* Xc0;    // (n, T, d, d) initial covariances
  const float* pri;    // (5, d, d)  Sigma0^-1, Q^-1, Q^-1 Phi, Phi' Q^-1 Phi, Phi
  float* Xm;           // (n, T, d)  out
  float* Xc;           // (n, T, d, d) out
  float* eh;           // (>= max_iter,) ELBO history, NaN-filled by the caller
  float* mh;           // (>= max_iter,) MSE history, NaN-filled by the caller
  float* stats;        // (5,) n_iter, converged, diverged, pat_count, last_elbo
  int n, T, num_blocks, max_iter, carry_pat, patience;
  int structure;       // 0 diag, 1 full, 2 block
  int corrected;       // 0 or 1
  float lr, tol, p, q, tr_rinv, logdet_R, logdet_S0, logdet_Q, carry_elbo;
};

// Dynamic shared memory the fit needs (bytes).
size_t tame_fused_fit_smem_bytes(int n, int T, int d, int num_blocks);

cudaError_t tame_fused_fit(const FusedFitArgs& args, int d,
                           cudaStream_t stream);
