// Host-side launchers of the port's CUDA kernels.  Plain pointers and
// sizes only, so the .cu files never include PyTorch's headers; the one
// binding file (binding.cpp) checks tensors and calls these.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a size no
// kernel takes).  K1, K2 and K4 take d in {4, ..., 12} unrolled and every
// other even d up to 48 in a runtime-d kernel.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// K4: batched block-tridiagonal forward-backward smoother, one thread block
// per node.  D (n, T, d, d) SPD diagonal blocks, O (d, d) coupling, b (n, T,
// d); out mean (n, T, d), cov (n, T, d, d), cross (n, T-1, d, d), logdet
// (n,).  float32, row-major.
cudaError_t tame_fused_smoother(const float* D, const float* O, const float* b,
                                float* mean, float* cov, float* cross,
                                float* logdet, int n, int T, int d,
                                cudaStream_t stream);

// Shared memory of one K4 block (bytes): static for d in {4, ..., 12},
// dynamic for the runtime-d kernel (even d up to 48); 0 for any other d.
size_t tame_fused_smoother_smem_bytes(int d);

// K5: out[i, t, k] = sum_j M[t, i, j] bf16(Z[j, t, k]).  M (T, bs_pad,
// n_pad) int8 with n_pad % 16 == 0 and n <= n_pad; Z (n, T, K) float32;
// out (bs_pad, T, K) float32, every entry written.
cudaError_t tame_masked_contract(const int8_t* M, const float* Z, float* out,
                                 int T, int bs_pad, int n_pad, int n, int K,
                                 cudaStream_t stream);

// K6: row = W Z and col += W' Z per time step, Z rounded to bf16.  W (T, n,
// cols_pad) bf16 (__nv_bfloat16) with cols_pad % 8 == 0, zero past column
// n; Z (T, n, m) float32 with m <= 16; row (T, n, m) float32, every entry
// written; col (T, n, m) float32, zeroed by the caller.
cudaError_t tame_dual_contract(const void* W, const float* Z, float* row,
                               float* col, int T, int n, int cols_pad, int m,
                               cudaStream_t stream);

// K7: out[t, i, r] = sum_j W[t, i, j] bf16(Z[t, j, r]).  W (T, N, N) bf16
// (__nv_bfloat16); Z (T, N, R) float32 with 1 <= R <= 16; out (T, N, R)
// float32, every entry written.
cudaError_t tame_eta_contract(const void* W, const float* Z, float* out, int T,
                              int N, int R, cudaStream_t stream);
