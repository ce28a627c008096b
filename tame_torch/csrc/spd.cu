// K1 spd_solve_inv and K2 logdet_spd: one thread per small SPD system.
//
// Replace tame/ops/cholesky.py::_chol_solve_inv_kernel and ::_logdet_kernel,
// which lay the batch on the TPU's 128 lanes and pad the tail with identity
// systems.  Here each thread owns one system: it reads the lower triangle
// of its P, factors it in registers (chol.cuh), and writes mu (and P^-1 one
// column per solve, or log det P).  The ragged tail is a bounds check.
//
// Bound: device-memory traffic (~d^3 flops per (d^2 + d) floats read).
// Reading a row-major (B, d, d) batch with one system per thread is
// uncoalesced — neighbouring threads read addresses d^2 floats apart — and
// is accepted in this first version; L1/L2 serve the sector reuse.
#include "chol.cuh"
#include "kernels.h"

namespace {

constexpr int kThreads = 128;

template <int D>
__device__ __forceinline__ void load_lower(const float* __restrict__ P,
                                           float (&A)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = P[i * D + j];
}

template <int D, bool WITH_INVERSE>
__global__ void __launch_bounds__(kThreads)
spd_solve_inv_kernel(const float* __restrict__ P, const float* __restrict__ eta,
                     float* __restrict__ mu, float* __restrict__ cov, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float A[D][D], inv_diag[D], rhs[D], x[D];
  load_lower<D>(P + static_cast<size_t>(b) * D * D, A);
  chol_factor<D>(A, inv_diag);
#pragma unroll
  for (int i = 0; i < D; ++i) rhs[i] = eta[static_cast<size_t>(b) * D + i];
  chol_solve<D>(A, inv_diag, rhs, x);
#pragma unroll
  for (int i = 0; i < D; ++i) mu[static_cast<size_t>(b) * D + i] = x[i];
  if (WITH_INVERSE) {
    float* out = cov + static_cast<size_t>(b) * D * D;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      chol_inverse_column<D>(A, inv_diag, j, x);
#pragma unroll
      for (int i = 0; i < D; ++i) out[i * D + j] = x[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
logdet_spd_kernel(const float* __restrict__ P, float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float A[D][D], inv_diag[D];
  load_lower<D>(P + static_cast<size_t>(b) * D * D, A);
  out[b] = chol_factor<D>(A, inv_diag);
}

}  // namespace

cudaError_t tame_spd_solve_inv(const float* P, const float* eta, float* mu,
                               float* cov, int B, int d, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  switch (d) {
#define TAME_CASE(DD)                                                      \
  case DD:                                                                 \
    if (cov != nullptr)                                                    \
      spd_solve_inv_kernel<DD, true><<<grid, block, 0, stream>>>(P, eta, mu, \
                                                                 cov, B);  \
    else                                                                   \
      spd_solve_inv_kernel<DD, false><<<grid, block, 0, stream>>>(         \
          P, eta, mu, nullptr, B);                                         \
    break;
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t tame_logdet_spd(const float* P, float* out, int B, int d,
                            cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  switch (d) {
#define TAME_CASE(DD)                                                      \
  case DD:                                                                 \
    logdet_spd_kernel<DD><<<grid, block, 0, stream>>>(P, out, B);          \
    break;
    TAME_FOR_EACH_D(TAME_CASE)
#undef TAME_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
