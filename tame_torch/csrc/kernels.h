// Host-side launchers of the port's CUDA kernels.  Plain pointers and
// sizes only, so the .cu files never include PyTorch's headers; the one
// binding file (binding.cpp) checks tensors and calls these.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a size no
// kernel takes).  K1, K2 and K4 take every even d from 4 to 48, each in
// one design.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// K1: mu = P^-1 eta and, when cov != nullptr, cov = P^-1.
// P (B, d, d), eta (B, d), mu (B, d), cov (B, d, d); float32, row-major;
// only the lower triangle of P is read; P 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).
cudaError_t tame_spd_solve_inv(const float* P, const float* eta, float* mu,
                               float* cov, int B, int d, cudaStream_t stream);

// K2: out[b] = log det P[b].  P (B, d, d) float32 row-major, as K1 takes it.
cudaError_t tame_logdet_spd(const float* P, float* out, int B, int d,
                            cudaStream_t stream);

// Launch geometry of K1 with the inverse (narrow false) or of K1 without
// it and K2 past d = 12 (narrow true; K2 up to d = 12 runs one thread per
// system) at state dimension d: the column capacity, the lanes per system
// and the systems per block (all 0 for a d they do not take).
struct SpdGeometry {
  int capacity, group, systems;
};
SpdGeometry tame_spd_geometry(int d, bool narrow);

// K3: the whole damped-CAVI fit in one thread block.  Every input is read
// as the caller holds it; the kernel derives the dyad weights, the prior
// matrices and the log-determinants itself.
struct FusedFitArgs {
  const float* Y;       // (n, n, T, 2)
  const float* rinv;    // (2, 2)  R^-1
  const float* Sigma0;  // (d, d)
  const float* Q;       // (d, d)
  const float* Phi;     // (d, d)
  const float* Xm0;     // (n, T, d)  initial means
  const float* Xc0;     // (n, T, d, d) initial covariances
  float* Xm;            // (n, T, d)  out
  float* Xc;            // (n, T, d, d) out
  float* hist;          // (2 hist_len + 5,) out: ELBO history, MSE history
                        // (NaN past the stop), then n_iter, converged,
                        // diverged, pat_count, last_elbo
  float* gdata;         // (4, T, n, n) scratch: W0, W1, y0, y0^T time-major,
                        // where the layout does not stage them (else unused)
  int n, T, num_blocks, max_iter, hist_len, carry_pat, patience;
  int structure;        // 0 diag, 1 full, 2 block
  int corrected;        // 0 or 1
  int pad, staged;      // the layout; set by tame_fused_fit
  float lr, tol, carry_elbo;
};

// The layout a fit runs with: bit 0 set when W0, W1 and y0 are staged in
// shared memory (else gdata is needed), bit 1 when the state rows have the
// odd pitch d + 1; -1 when no layout fits 227 KB.
int tame_fused_fit_layout(int n, int T, int d, int num_blocks);

// Dynamic shared memory of that layout (bytes; 0 when none fits).
size_t tame_fused_fit_smem_bytes(int n, int T, int d, int num_blocks);

cudaError_t tame_fused_fit(const FusedFitArgs& args, int d,
                           cudaStream_t stream);

// K4: batched block-tridiagonal forward-backward smoother, one warp per
// node, every even d from 4 to 48.  D (n, T, d, d) SPD diagonal blocks, O
// (d, d) coupling, b (n, T, d); out mean (n, T, d), cov (n, T, d, d), cross
// (n, T-1, d, d), logdet (n,).  float32, row-major.
cudaError_t tame_fused_smoother(const float* D, const float* O, const float* b,
                                float* mean, float* cov, float* cross,
                                float* logdet, int n, int T, int d,
                                cudaStream_t stream);

// Dynamic shared memory of one K4 block holding `warps` nodes (bytes); 0
// for a d or a warp count K4 does not take.
size_t tame_fused_smoother_smem_bytes(int d, int warps);

// Nodes per K4 block for n trajectories at state dimension d (0 for a d
// K4 does not take).
int tame_fused_smoother_warps(int n, int d);

// K5: out[i, t, k] = sum_j M[t, i, j] bf16(Z[j, t, k]).  M (T, bs_pad,
// n_pad) int8 with n_pad % 16 == 0 and n <= n_pad; Z (n, T, K) float32 with
// T ceil(K / 64) <= 65535; out (bs_pad, T, K) float32, every entry written.
cudaError_t tame_masked_contract(const int8_t* M, const float* Z, float* out,
                                 int T, int bs_pad, int n_pad, int n, int K,
                                 cudaStream_t stream);

// K6: row = W Z and col = W' Z per time step for columns k0 .. k0 + 15 of
// Z (fewer at the end), Z rounded to bf16; a cluster of 8 blocks per time
// step, a fixed summation order (the same bits on every launch).  W (T, n,
// cols_pad) bf16 (__nv_bfloat16) with cols_pad % 8 == 0, zero past column
// n; Z, row and col (T, n, m) float32; every entry of those columns of row
// and col is written.  cudaErrorInvalidValue where the block's shared
// memory (tame_dual_contract_smem_bytes) exceeds 227 KB.
cudaError_t tame_dual_contract(const void* W, const float* Z, float* row,
                               float* col, int T, int n, int cols_pad, int m,
                               int k0, cudaStream_t stream);

// Dynamic shared memory of one K6 block at n for a slice of `width` <= 16
// columns (bytes; 0 for a width K6 does not take).
size_t tame_dual_contract_smem_bytes(int n, int width);

// K7: out[i, t, k] = sum_j W[t, i, j] z(Z[j, t, k]) for 0 <= i < m.  W
// (T, m, n) bf16 (__nv_bfloat16, w_bf16 != 0; z rounds to bf16) or float32
// (z the identity), partners at unit stride, time steps and rows at strides
// w_t and w_i (elements); Z (n, T, R) float32 at strides z_j, z_t, z_k with
// 1 <= R <= 92; out (m, T, R) float32, contiguous, every entry written.
// sms: the card's SM count, which sets the tiling.
cudaError_t tame_eta_contract(const void* W, int w_bf16, long long w_t,
                              long long w_i, const float* Z, long long z_j,
                              long long z_t, long long z_k, float* out, int T,
                              int m, int n, int R, int sms,
                              cudaStream_t stream);
